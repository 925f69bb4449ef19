"""Single-device training in the port against the reference, on the CPU.

* The training step at reduced width, float32 compute: `lm_loss` and every
  gradient of `accumulate_grads` (n_micro 1 and 2) against the reference's
  `M.lm_loss` + ``jax.value_and_grad`` (no mesh: the reference's training
  loop does not run on the installed JAX), with the flash-kernel attention
  branch on both sides (the port's plain flash versions, the reference's
  Pallas kernels in interpret mode).  Parameters come from the
  reference's `lm_init` through `params_from_numpy`.
* `adamw_update` on the same parameters and gradients as the reference's.
* The token stream, bit for bit; the checkpoint format, read across.
* The training loop: resume exactness, the injected failure, preemption,
  and the front end in a subprocess.

Tolerances: the loss rtol 1e-5 (float32 summation order); gradients
rtol 1e-3 / atol 1e-4 (the reference's own flash-gradient test); AdamW
rtol 1e-5 / atol 1e-7 (the same float32 operations in the same order,
up to the order of the global-norm sum).
"""
import dataclasses
import math
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import accumulate_grads as j_accumulate
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.tree import leaves
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import train as T
from repro_torch.models import model as TM
from repro_torch.models.interop import params_from_numpy
from repro_torch.optim import (AdamWConfig, accumulate_grads, adamw_init,
                               adamw_update)
from repro_torch.runtime import PreemptionHandler

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
G_TOL = dict(rtol=1e-3, atol=1e-4)
KNOBS = dict(compute_dtype="float32", attn_bq=32, attn_bkv=32,
             attn_cfg="base", attn_bwd_cfg="base")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               attn_backend="pallas", **KNOBS)
    tcfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                               attn_backend="cuda", **KNOBS)
    jparams = jax.tree.map(np.asarray, JM.lm_init(jax.random.PRNGKey(0),
                                                  jcfg))
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32),
             "labels": rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)}
    return jcfg, tcfg, jparams, batch


def _port(tree, tcfg):
    return params_from_numpy(jax.tree.map(np.asarray, tree), tcfg, "cpu",
                             torch.float32)


def _tparams(jparams, tcfg):
    tp = _port(jparams, tcfg)
    for p in leaves(tp):
        p.requires_grad_(True)
    return tp


def _tbatch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


@pytest.mark.parametrize("n_micro", [1, 2])
def test_loss_and_gradients_match_reference(setup, n_micro):
    jcfg, tcfg, jparams, batch = setup
    jloss, jgrads, _ = j_accumulate(lambda p, b: JM.lm_loss(p, b, jcfg),
                                    jparams, batch, n_micro)
    tloss, tgrads, metrics = accumulate_grads(
        lambda p, b: TM.lm_loss(p, b, tcfg), _tparams(jparams, tcfg),
        _tbatch(batch), n_micro)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert metrics["tokens"].item() == B * S // n_micro
    want = _port(jgrads, tcfg)
    assert len(leaves(tgrads)) == len(leaves(want))
    for g, w in zip(leaves(tgrads), leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **G_TOL)


def test_adamw_update_matches_reference(setup):
    """Two updates from the same parameters and gradients (scaled so the
    global-norm clip acts): parameters, m, v, step and the norm."""
    _, tcfg, jparams, _ = setup
    rng = np.random.default_rng(9)
    jgrads = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * 0.05).astype(np.float32),
        jparams)
    cfg = dict(lr=1e-3, weight_decay=0.1, clip_norm=1.0)
    jp, js = jparams, j_adamw_init(jparams)
    tp, tg = _port(jparams, tcfg), _port(jgrads, tcfg)
    ts = adamw_init(tp)
    for _ in range(2):
        jp, js, jgn = j_adamw_update(jp, jgrads, js, JAdamWConfig(**cfg))
        tp, ts, tgn = adamw_update(tp, tg, ts, AdamWConfig(**cfg))
        assert float(jgn) > cfg["clip_norm"]
        np.testing.assert_allclose(tgn.item(), float(jgn), rtol=1e-5)
        assert int(ts["step"]) == int(js["step"])
        for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            for g, w in zip(leaves(got), leaves(_port(want, tcfg))):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                           atol=1e-7)


def test_remat_full_gives_the_same_gradients(setup):
    _, tcfg, jparams, batch = setup
    grads = {}
    for remat in ("none", "full"):
        _, grads[remat], _ = accumulate_grads(
            lambda p, b: TM.lm_loss(p, b, tcfg, remat=remat),
            _tparams(jparams, tcfg), _tbatch(batch), 1)
    for g, w in zip(leaves(grads["full"]), leaves(grads["none"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(NotImplementedError, match="dots"):
        TM.lm_loss(_tparams(jparams, tcfg), _tbatch(batch), tcfg,
                   remat="dots")


def test_lm_init_float32_master_weights():
    cfg = t_get_config("qwen3-0.6b").reduced()
    p = TM.lm_init(cfg, torch.Generator().manual_seed(0), device="cpu",
                   dtype=torch.float32)
    assert p["embed"].dtype == torch.float32
    assert p["layers"][0]["ffn"]["w1"].dtype == torch.float32
    assert p["layers"][0]["ln1"]["scale"].dtype == torch.float32
    assert TM.lm_init(cfg, device="cpu")["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1234])
def test_token_pipeline_matches_reference(seed):
    kw = dict(vocab=512, seq_len=64, global_batch=3, seed=seed)
    jp, tp = JTokenPipeline(JDataConfig(**kw)), TokenPipeline(DataConfig(**kw))
    for _ in range(3):
        want, got = jp.next_batch(), tp.next_batch()
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int64
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tp.state_dict() == jp.state_dict()


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 8, generator=g),
                       "layers": [{"b": torch.randn(8, generator=g)
                                   .bfloat16()}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_round_trip_integrity_and_retention(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), keep=2, save_interval_steps=1)
    for step in (1, 2, 3, 4):
        mgr.save(step, tree, extra={"step": step})
        tree["params"]["w"].add_(1.0)      # in place, after the snapshot
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000003",
                                            "step_00000004"]
    assert mgr.latest_step() == 4
    skel = _tree()
    got, manifest = mgr.restore(skel)
    assert manifest["extra"] == {"step": 4}
    want = _tree()["params"]["w"]
    for _ in range(3):                     # the snapshot of step 4
        want.add_(1.0)
    np.testing.assert_array_equal(got["params"]["w"].numpy(), want.numpy())
    assert got["params"]["layers"][0]["b"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["layers"][0]["b"],
                       skel["params"]["layers"][0]["b"])
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 7
    npz = tmp_path / "step_00000004" / "arrays.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0xFF
    npz.write_bytes(bytes(data))
    with pytest.raises(IOError, match="integrity"):
        load_checkpoint(str(tmp_path), skel)


def test_checkpoint_format_is_the_reference_format(tmp_path):
    """A checkpoint the port writes, the reference reads, and back."""
    tree = _tree()
    host = jax.tree.map(np.asarray, {
        "params": {"w": tree["params"]["w"].numpy(),
                   "layers": [{"b": tree["params"]["layers"][0]["b"]
                               .float().numpy()}]},
        "opt": {"step": np.int32(7)}})
    save_checkpoint(str(tmp_path / "port"), 5, tree, extra={"k": 1})
    got, manifest = j_load(str(tmp_path / "port"), host)
    assert manifest["step"] == 5 and manifest["extra"] == {"k": 1}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(host)):
        np.testing.assert_array_equal(np.asarray(g), w)
    j_save(str(tmp_path / "ref"), 6, host)
    back, _ = load_checkpoint(str(tmp_path / "ref"), _tree())
    for g, w in zip(leaves(back), leaves(_tree())):
        assert g.dtype == w.dtype and torch.equal(g, w)


TRAIN = dict(batch=2, seq=32, log_every=1000, device="cpu", seed=3)


def _cfg():
    return dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                               attn_bq=32, attn_bkv=32)


def test_resume_is_exact(tmp_path):
    """4 steps, a checkpoint, then 4 resumed steps give exactly the losses
    of 8 uninterrupted steps (the property the reference asks of its own
    training loop in `tests/test_system.py::test_resume_is_exact`)."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    full, _ = T.train(_cfg(), steps=8, ckpt_dir=d1, save_every=4, **TRAIN)
    first, _ = T.train(_cfg(), steps=4, ckpt_dir=d2, save_every=4, **TRAIN)
    part2, _ = T.train(_cfg(), steps=8, ckpt_dir=d2, save_every=4, **TRAIN)
    assert len(full) == 8 and all(math.isfinite(x) for x in full)
    assert first == full[:4] and part2 == full[4:]


def test_injected_failure_is_absorbed_by_retry():
    clean, _ = T.train(_cfg(), steps=4, ckpt_dir=None, **TRAIN)
    losses, _ = T.train(_cfg(), steps=4, ckpt_dir=None, fail_at_step=2,
                        **TRAIN)
    assert losses == clean


def test_preemption_stops_with_a_checkpoint(tmp_path):
    """A trigger during step 1 stops the loop before step 2, writes a
    checkpoint that resumes at step 2, and uninstalls the handler."""
    before = signal.getsignal(signal.SIGTERM)
    pre = PreemptionHandler()

    def on_step(step, loss, gn, seconds):
        assert math.isfinite(loss) and math.isfinite(gn) and seconds > 0
        if step == 1:
            pre.trigger()

    ckpt = str(tmp_path / "c")
    losses, _ = T.train(_cfg(), steps=4, ckpt_dir=ckpt, save_every=100,
                        preemption=pre, on_step=on_step, **TRAIN)
    assert len(losses) == 2
    assert signal.getsignal(signal.SIGTERM) is before
    assert CheckpointManager(ckpt).latest_step() == 2
    rest, _ = T.train(_cfg(), steps=4, ckpt_dir=ckpt, **TRAIN)
    full, _ = T.train(_cfg(), steps=4, ckpt_dir=None, **TRAIN)
    assert losses + rest == full


def test_front_end_trains_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "64"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2                   # steps 0 and 2 (the last)
    assert all(math.isfinite(float(ln.split()[3])) for ln in lines)
    assert "final loss" in proc.stdout


def test_front_end_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train(_cfg(), steps=1, batch=2, seq=32, ckpt_dir=None)
