"""Runtime pieces the engine's serving surface needs."""
