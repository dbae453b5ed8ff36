"""The design probes' text substitutions against the checkout's sources.

``flexflow_tpu_torch/tools/flash_probe.py`` and ``paged_probe.py`` build
copies of ``csrc/flash_attention.cu``, ``csrc/paged_attention.cu`` and the
``csrc/common.cuh`` they include with one design choice changed each: a
text substitution in the source it names. A substitution whose text a
later change took out of its source would make the probe stop; these
cases find that on the CPU, without a card or a compiler: each variant
applies, changes what it names and leaves the other source as it is.

    python -m pytest tests/test_torch_port_probe_variants.py
"""
import pytest

from flexflow_tpu_torch.tools import flash_probe, paged_probe

pytestmark = pytest.mark.torch_port

PAGED_VARIANTS = {**paged_probe.VARIANTS, **paged_probe.SPLIT_VARIANTS,
                  **paged_probe.WINDOW_VARIANTS}


def _check(main, variants, name):
    sources = flash_probe.variant_sources(main, {name: variants[name]})
    base, got = sources["source"], sources[name]
    assert set(got) == {main, flash_probe.COMMON}
    patched = {file for file, _, _ in variants[name]}
    for file in got:
        assert (got[file] != base[file]) == (file in patched), (name, file)


@pytest.mark.parametrize("name", sorted(flash_probe.VARIANTS))
def test_flash_probe_variant_applies(name):
    _check(flash_probe.FLASH, flash_probe.VARIANTS, name)


@pytest.mark.parametrize("name", sorted(PAGED_VARIANTS))
def test_paged_probe_variant_applies(name):
    _check(paged_probe.PAGED, PAGED_VARIANTS, name)


def test_a_stale_substitution_raises():
    stale = {"stale": [(paged_probe.PAGED, "no such text in the source", "x")]}
    with pytest.raises(RuntimeError, match="stale"):
        flash_probe.variant_sources(paged_probe.PAGED, stale)
