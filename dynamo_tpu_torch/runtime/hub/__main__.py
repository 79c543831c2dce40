"""Run a standalone hub: ``python -m dynamo_tpu_torch.runtime.hub [--port 2379]``."""

import argparse
import asyncio

from dynamo_tpu_torch.runtime.hub.server import HubServer
from dynamo_tpu_torch.utils.logging import configure_logging


async def _main(host: str, port: int) -> None:
    hub = HubServer()
    await hub.start(host, port)
    # the bound port on stdout (with --port 0 the OS picks it), for a
    # parent process that starts the hub and reads where it listens
    print(f"hub listening on {host}:{hub.port}", flush=True)
    await hub.serve_forever()


def main() -> None:
    configure_logging()
    parser = argparse.ArgumentParser(description="dynamo_tpu_torch hub (control plane)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=2379)
    parser.add_argument(
        "--native", action="store_true",
        help="the C++ daemon: not ported (ROADMAP M17, the native hub)",
    )
    args = parser.parse_args()
    if args.native:
        raise NotImplementedError(
            "--native: the C++ hub daemon and its C-FFI event library are not ported "
            "to dynamo_tpu_torch yet (ROADMAP M17: llm/kv_router/c_ffi.py and the "
            "native hub); the asyncio hub serves the same wire")
    try:
        asyncio.run(_main(args.host, args.port))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
