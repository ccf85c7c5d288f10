"""The port's ``utils/requirements.py`` against the JAX package's: the same
normalisation, injection and merge on the same inputs; the only
difference is the set of packages the worker image provides (torch and
triton in place of the JAX stack)."""

import re

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu.utils import requirements as jax_requirements
from bioengine_tpu_torch.utils.requirements import (
    INJECTED,
    SKIP_PACKAGES,
    get_pip_requirements,
    normalize_requirement,
    update_requirements,
)

SKIPPED_BY_EITHER = SKIP_PACKAGES | jax_requirements.SKIP_PACKAGES

_name = st.from_regex(r"[A-Za-z][A-Za-z0-9_.\-]{0,14}", fullmatch=True)
_version = st.from_regex(r"[0-9]{1,3}(\.[0-9]{1,3}){0,2}(rc[0-9])?", fullmatch=True)
_spec = st.one_of(
    _name,
    st.builds(lambda n, op, v: f"{n}{op}{v}", _name,
              st.sampled_from(["==", ">=", "<=", "~=", ">", "<", "!=", " >= ", "=="]), _version),
    st.builds(lambda n, e, v: f"{n}[{e}]>={v}", _name, _name, _version),
    st.builds(lambda n, v, m: f"{n}=={v}; {m}", _name, _version, st.sampled_from(["python_version>'3.8'", ""])),
    st.sampled_from(sorted(SKIPPED_BY_EITHER)),
    st.builds(lambda n, v: f"{n}>={v}", st.sampled_from(sorted(SKIPPED_BY_EITHER)), _version),
    st.text(max_size=12),
)


def _name_of(req: str) -> str:
    return re.split(r"[=<>~!\[ ]", req.strip(), maxsplit=1)[0].lower()


def test_skip_set_is_the_ports_image_stack():
    assert SKIP_PACKAGES == frozenset({"torch", "triton"})
    assert INJECTED == jax_requirements.INJECTED


@given(_spec)
@settings(max_examples=200, deadline=None)
def test_normalize_requirement_equals_the_jax_one(spec):
    assert normalize_requirement(spec) == jax_requirements.normalize_requirement(spec)


@given(st.lists(_spec, max_size=8))
@settings(max_examples=100, deadline=None)
def test_update_requirements_equals_the_jax_one_up_to_the_skip_set(specs):
    """On the same app requirements the two merges agree once each drops
    what its own image provides; a name neither image provides is merged
    the same way by both."""
    ours = update_requirements(specs)
    theirs = jax_requirements.update_requirements([s for s in specs if _name_of(s) not in SKIP_PACKAGES])
    # JAX also drops its own stack; the port keeps it (it is not the port's image)
    kept_jax_stack = [s for s in specs if _name_of(s) in jax_requirements.SKIP_PACKAGES - SKIP_PACKAGES]
    merged = {_name_of(r): r for r in theirs}
    for s in kept_jax_stack:
        merged[_name_of(s)] = normalize_requirement(s)
    assert ours == sorted(merged.values())
    neither = [s for s in specs if _name_of(s) not in SKIPPED_BY_EITHER]
    assert update_requirements(neither) == jax_requirements.update_requirements(neither)


def test_get_pip_requirements_equals_the_jax_one():
    assert get_pip_requirements() == jax_requirements.get_pip_requirements()
    assert get_pip_requirements(["numpy", "torch", "triton"]) == [
        r for r in jax_requirements.get_pip_requirements(["numpy"])
    ]


class TestRequirements:
    """The JAX package's ``tests/test_utils.py::TestRequirements`` cases on
    the port, with the port's image stack."""

    def test_normalize_rewrites_operator_keeps_version(self):
        assert normalize_requirement("numpy>=1.26") == "numpy==1.26"
        assert normalize_requirement("pkg~=2.1.0") == "pkg==2.1.0"

    def test_normalize_bare_name_passthrough(self):
        assert normalize_requirement("not-a-real-pkg-xyz") == "not-a-real-pkg-xyz"

    def test_skip_is_exact_name_not_prefix(self):
        reqs = update_requirements(["torchmetrics>=1.0", "tritonclient==2.0", "jaxtyping==0.2.0"])
        names = [r.split("==")[0] for r in reqs]
        assert {"torchmetrics", "tritonclient", "jaxtyping"} <= set(names)

    def test_injection_skips_compute_stack(self):
        reqs = update_requirements(["torch>=2.0", "triton", "somepkg==1.0", "jax>=0.4"])
        names = [r.split("==")[0] for r in reqs]
        assert "torch" not in names and "triton" not in names
        assert "somepkg" in names and "jax" in names

    def test_framework_pins_present(self):
        names = [r.split("==")[0] for r in get_pip_requirements()]
        assert "numpy" in names

    @pytest.mark.parametrize("app", [["numpy==1.0"], ["NumPy>=1.0"]])
    def test_app_pin_wins_on_clash(self, app):
        reqs = update_requirements(app)
        assert [r for r in reqs if r.lower().startswith("numpy")] == [normalize_requirement(app[0])]
        assert reqs == jax_requirements.update_requirements(app)
