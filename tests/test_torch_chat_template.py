"""The port's chat-template renderer (dynamo_tpu_torch/llm/chat_template.py)
against the JAX package's `PromptFormatter` (jinja2 with trim_blocks,
lstrip_blocks, keep_trailing_newline and its globals and tojson filter):
the same text on tests/fixtures.py's CHAT_TEMPLATE and on a case for each
construct of the subset, the same failures where jinja2 fails, and a
TemplateError naming any construct outside the subset."""

from __future__ import annotations

import pytest

from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.preprocessor import PromptFormatter as JaxFormatter
from dynamo_tpu_torch.llm.chat_template import ChatTemplate, TemplateError
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import PromptFormatter

from .fixtures import CHAT_TEMPLATE
from .torch_fixtures import bpe_model_dir

MESSAGES = [
    {"role": "system", "content": "be brief"},
    {"role": "user", "content": "hi  there\n"},
    {"role": "assistant", "content": "hello", "name": "bot"},
    {"role": "user", "content": "é ☃ {{ not a tag }}"},
]

# (name, template): each construct of the subset, alone or with others
CASES = [
    ("fixture", CHAT_TEMPLATE),
    ("for_loop_vars", "{% for m in messages %}{{ loop.index0 }}/{{ loop.index }}/"
     "{{ loop.first }}/{{ loop.last }}/{{ loop.length }}:{{ m.role }}\n"
     "{% endfor %}"),
    ("for_unpack", "{% for a, b in [[1, 2], (3, 4)] %}{{ a }}{{ b }}{% endfor %}"),
    ("for_dict_and_string", "{% for k in {'x': 1, 'y': 2} %}{{ k }}{% endfor %}"
     "{% for c in 'ab' %}[{{ c }}]{% endfor %}"),
    ("if_elif_else", "{% for m in messages %}{% if m.role == 'system' %}S{% elif m.role != "
     "'user' and not loop.last %}A{% else %}U{% endif %}{% endfor %}"),
    ("set_scoping", "{% set c = 0 %}{% for i in [1, 2, 3] %}{% set c = c + i %}{{ c }},"
     "{% endfor %}{{ c }}{% set d = 'x' ~ c %}{{ d }}"),
    ("set_in_if_in_loop", "{% for i in [1, 2] %}{% if loop.first %}{% set y = 5 %}"
     "{% endif %}{{ y }},{% endfor %}{{ y }}"),
    ("access", "{{ messages[0].role }}{{ messages[-1]['content'] }}{{ messages[1:3]|length }}"
     "{{ 'abc'[::-1] }}{{ messages[2].name }}{{ messages[0].name }}|{{ {'a': [1, 2]}.a[1] }}"),
    ("literals", "{{ 'a\\nb' }}{{ \"q'q\" }}{{ 'x' 'y' }}{{ none }}{{ true }}{{ False }}"
     "{{ 1.5 }}{{ -2 }}{{ 1_000 }}{{ [1, 'a'] }}{{ (1, 2) }}{{ {'k': none} }}"),
    ("operators", "{{ 1 + 2 + 3 }}|{{ 'a' ~ 1 ~ none }}|{{ 'a' + 'b' ~ 'c' }}|{{ 1 < 2 < 3 }}|"
     "{{ 2 >= 3 }}|{{ 2 <= 3 > 1 }}|{{ 'a' in 'cat' }}|{{ 4 not in [1] }}|{{ 0 or 'z' }}|"
     "{{ 1 and 0 }}|{{ not 1 }}|{{ -(1 + 2) }}|{{ loop is defined }}"),
    ("conditional_expr", "{{ 'y' if messages else 'n' }}{{ 'q' if false }}|"
     "{{ 'a' if 0 else 'b' if 1 else 'c' }}"),
    ("tests", "{{ tools is none }}{{ foo is defined }}{{ foo is not defined }}"
     "{{ 'x' is string }}{{ messages is string }}{{ tools is not none }}"
     "{{ not foo is defined }}"),
    ("filters", "{{ messages|tojson }}|{{ messages[0]|tojson(indent=2) }}|"
     "{{ messages|length }}|{{ '  x  '|trim }}|{{ 'aBc'|upper }}"
     "{{ 'aBc'|lower }}|{{ foo|length }}|{{ foo|trim }}|{{ 'ab'|upper ~ 'c' }}"),
    ("undefined_prints_empty", "[{{ foo }}][{{ messages[0].nope }}][{{ foo ~ 'x' }}]"
     "{% if foo %}no{% endif %}{% for x in foo %}no{% endfor %}{{ foo == foo }}"),
    ("whitespace_control", "  {% if true %}\n  x\n  {% endif %}\n  y\n{%- for m in messages -%}"
     "\n  {{- m.role }}\n{%- endfor %}\n{{- 'a' -}}   \n  {{ 'b' }}"),
    ("plus_and_comments", "{%+ if true %} a{% endif +%}\nb\n  {# c #}\nd{#- e -#}  \nf\n"
     "  {#+ g #}h"),
    ("trailing_newline_and_crlf", "a\r\nb{{ 'x' }}\r\n{% if true %}\r\nc{% endif %}\n"),
    ("generation_prompt", "{% for m in messages %}<|{{ m.role }}|>{{ m.content | trim }}"
     "{{ eos_token }}{% endfor %}{% if add_generation_prompt %}{{ bos_token }}"
     "<|assistant|>{% endif %}"),
    ("strftime_now", "{{ strftime_now('%Y') | length }}"),
    ("tojson_unicode", "{{ {'s': 'é☃'}|tojson }}{{ 'é'|tojson(ensure_ascii=False) }}"),
]


def _render_pair(template: str, **ctx):
    kw = dict(messages=MESSAGES, tools=None, add_generation_prompt=True)
    kw.update(ctx)
    ref = JaxFormatter(template, "<s>", "</s>").render(**kw)
    got = PromptFormatter(template, "<s>", "</s>").render(**kw)
    return ref, got


@pytest.mark.parametrize("name, template", CASES, ids=[c[0] for c in CASES])
def test_renders_as_jinja2(name, template):
    ref, got = _render_pair(template)
    assert got == ref


def test_fixture_card_template_and_no_generation_prompt(tmp_path):
    path = bpe_model_dir(str(tmp_path))
    card = ModelDeploymentCard.from_local_path(path, name="tiny")
    jcard = JaxCard.from_local_path(path, name="tiny")
    for gen in (True, False):
        got = PromptFormatter.from_card(card).render(MESSAGES, add_generation_prompt=gen)
        ref = JaxFormatter.from_card(jcard).render(MESSAGES, add_generation_prompt=gen)
        assert got == ref


@pytest.mark.parametrize("template", [
    "{{ raise_exception('bad input') }}",
    "{{ foo.bar }}",
    "{{ foo + 1 }}",
    "{{ foo < 1 }}",
    "{{ 1 + 'a' }}",
])
def test_fails_where_jinja2_fails(template):
    import jinja2

    with pytest.raises((jinja2.TemplateError, TypeError)):
        _render_pair(template)  # the jinja2 side raises first
    with pytest.raises((TemplateError, TypeError)):
        PromptFormatter(template, None, None).render(MESSAGES)


@pytest.mark.parametrize("template, named", [
    ("{% macro f() %}{% endmacro %}", "macro"),
    ("{% for m in messages %}{% else %}{% endfor %}", "for ... else"),
    ("{% for m in messages if m %}{% endfor %}", "'if' in a for statement"),
    ("{{ messages|join(',') }}", "join"),
    ("{{ messages is divisibleby(2) }}", "divisibleby"),
    ("{{ messages is mapping }}", "mapping"),
    ("{{ messages|count }}", "count"),
    ("{{ 7 // 2 }}", "'//'"),
    ("{{ loop.index0 - 1 }}", "'-'"),
    ("{{ 2 * 3 }}", "'\\*'"),
    ("{{ messages[0].content.strip() }}", "strip"),
    ("{{ messages[0].items() }}", "items"),
    ("{{ namespace(x=1) }}", "globals"),
    ("{% set ns.x = 1 %}", "set name = expression"),
    ("{% raw %}x{% endraw %}", "raw"),
    ("{% include 'x' %}", "include"),
])
def test_unsupported_constructs_raise(template, named):
    with pytest.raises(TemplateError, match=named):
        ChatTemplate(template).render(messages=MESSAGES)


def test_raise_exception_message():
    with pytest.raises(TemplateError, match="only user and assistant"):
        ChatTemplate("{% if messages[0].role == 'system' %}"
                     "{{ raise_exception('only user and assistant') }}{% endif %}"
                     ).render(messages=MESSAGES)
