"""The port's configuration surface equals the reference's: every field of
every arch (published and reduced), the derived properties, and the
coarsening label grammar.  Pure Python on both sides, so equality is exact."""
import dataclasses

import pytest

from repro.configs import ARCHS, get_config
from repro.core.coarsening import CoarseningConfig as JCfg
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.coarsening import CoarseningConfig as TCfg
from repro_torch.core.coarsening import resolve

LABELS = ("base", "none", "con2", "con4", "con8", "gap2", "gap4", "gap8",
          "consecutive:4", "gapped:8", "con:2", "gap:4", "con4+pipe2",
          "gap2+simd2", "con8+pipe2+simd4", "pipe4", "simd2", "con1",
          "gap1+simd2", "CON2, PIPE2")


def test_registry_lists_the_same_archs():
    assert T_ARCHS == ARCHS


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _derived(cfg):
    return dict(vocab_padded=cfg.vocab_padded, hd=cfg.hd,
                layer_kinds=cfg.layer_kinds(),
                n_experts_padded=cfg.n_experts_padded,
                param_count=cfg.param_count())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_every_field_matches_reference(arch, reduced):
    want, got = get_config(arch), t_get_config(arch)
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert _fields(got) == _fields(want)
    assert _derived(got) == _derived(want)


@pytest.mark.parametrize("label", LABELS)
def test_label_parses_and_prints_the_same(label):
    want, got = JCfg.parse(label), TCfg.parse(label)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.label == want.label
    assert TCfg.parse(got.label) == got          # label round-trips


@pytest.mark.parametrize("kind", ["none", "consecutive", "gapped"])
@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_constructor_normalisation_matches(kind, degree):
    for repl, vw in ((1, 1), (2, 1), (1, 4), (2, 2)):
        want = JCfg(kind, degree, repl, vw)
        got = TCfg(kind, degree, repl, vw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.label == want.label


def test_bad_labels_raise_like_reference():
    for bad in ("warp4", "con", "gapx"):
        with pytest.raises(ValueError):
            JCfg.parse(bad)
        with pytest.raises(ValueError):
            TCfg.parse(bad)


def test_auto_resolves_to_base_until_the_tuner_is_ported():
    """With the tuner ported, "auto" resolves per call site through
    `ops.resolve_cfg` (a kernel family and shape): on the plain path
    (backend "ref") to base, without the tuner.  The label parser
    `resolve` refuses a bare "auto" and parses labels as before."""
    from repro_torch.kernels import ops
    assert ops.resolve_cfg("auto", "matmul", (128, 256, 256),
                           dtype="bfloat16", backend="ref") == TCfg()
    with pytest.raises(ValueError, match="resolve_cfg"):
        resolve("auto")
    assert resolve("con2") == TCfg("consecutive", 2)
    cfg = TCfg("gapped", 4)
    assert resolve(cfg) is cfg
