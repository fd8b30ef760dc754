"""The port's training launcher (``repro_torch.launch.train``, reduced configs,
on the CPU): a crash and a restore bit for bit, the reference driver's
losses, compressed gradients, the embedding families it refuses (and that
train through ``make_train_step``), the card as its default device.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.lm import LM as JaxLM
from repro_torch.configs import get_arch
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step
from repro_torch.tree import named_leaves

from _torch_train_pair import EMBED_ARCHS  # noqa: I001  (tests/ helper)

DRIVER_ARGS = ["--arch", "qwen2_0_5b", "--steps", "12", "--ckpt-every", "5", "--crash-at", "8",
               "--kill-hosts", "1", "--ckpt-hosts", "6", "--ckpt-parity", "2", "--batch", "2",
               "--seq", "32"]


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmoe_1b_7b", "zamba2_7b"])
def test_train_driver_crash_restore_is_bit_for_bit(monkeypatch, arch):
    """The reference test's driver run (crash at 8, one host down, restore
    from the step-5 checkpoint) on the port, for the dense, MoE and hybrid
    families: two saves at least; the restored state equals the saved one
    bit for bit (parameters, AdamW state, data state); the replayed steps
    6-8 repeat their losses bit for bit (the MoE recompute routes as its
    forward did)."""
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import ECCheckpointStore

    saved, restored = {}, []
    real_save, real_restore = ECCheckpointStore.save, ECCheckpointStore.restore

    def save(self, step, state, *a, **kw):
        saved[step] = {"params": {n: v.clone() for n, v in named_leaves(state["params"])},
                       "opt": {n: v.clone() for n, v in named_leaves(state["opt"])},
                       "data": dict(state["data"])}
        return real_save(self, step, state, *a, **kw)

    def restore(self, *a, **kw):
        out = real_restore(self, *a, **kw)
        restored.append(out)
        return out

    monkeypatch.setattr(ECCheckpointStore, "save", save)
    monkeypatch.setattr(ECCheckpointStore, "restore", restore)
    args = list(DRIVER_ARGS)
    args[args.index("--arch") + 1] = arch
    out = train.main(args + ["--device", "cpu"])
    assert len(out["ckpts"]) >= 2 and all(st.success for st in out["ckpts"])
    assert [st.step for st in out["ckpts"]] == [5, 10]
    losses = out["losses"]
    assert len(losses) == 8 + 7 and all(np.isfinite(losses))
    assert losses[5:8] == losses[8:11]  # steps 6-8, before the crash and replayed
    (step, state), = restored
    want = saved[step]
    assert step == 5
    for part in ("params", "opt"):
        got = dict(named_leaves(state[part]))
        assert got.keys() == want[part].keys()
        for name, value in want[part].items():
            assert got[name].dtype == value.dtype and torch.equal(got[name], value), name
    assert {k: int(v) for k, v in state["data"].items()} == want["data"] == {"seed": 0, "step": 5}
    assert state["opt"]["step"].dtype == torch.int32


def test_train_driver_matches_reference_driver():
    """The port's driver started from the reference driver's parameters
    against the reference driver (``repro.launch.train.main``), same flags:
    the same checkpoint steps and successes; the first loss within 2e-2
    (measured 9.9e-4); every loss within 5e-2 (measured at most 0.0231: over
    12 AdamW steps at lr 1e-3 the runs drift apart, since each element
    whose gradient sign differs moves 2 lr the other way)."""
    from repro.launch.train import main as jax_main
    from repro_torch.launch.train import main

    want = jax_main(list(DRIVER_ARGS))
    cfg = jax_get_arch("qwen2_0_5b").reduced()
    params = params_from_numpy(jax.tree.map(
        np.asarray, JaxLM(cfg, max_pos=32).init_params(jax.random.PRNGKey(0))))
    got = main(DRIVER_ARGS + ["--device", "cpu"], params=params)
    assert [(s.step, s.success) for s in got["ckpts"]] == [(s.step, s.success)
                                                           for s in want["ckpts"]]
    assert len(got["losses"]) == len(want["losses"])
    assert abs(got["losses"][0] - want["losses"][0]) <= 2e-2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=5e-2)


def test_train_driver_with_compressed_grads():
    """``--compress-grads`` (error-feedback int8): finite losses that fall,
    within 5e-2 of the reference driver's with the same flag and weights."""
    from repro.launch.train import main as jax_main
    from repro_torch.launch.train import main

    args = ["--arch", "qwen2_0_5b", "--steps", "8", "--ckpt-every", "4", "--batch", "2",
            "--seq", "32", "--compress-grads"]
    want = jax_main(list(args))
    cfg = jax_get_arch("qwen2_0_5b").reduced()
    params = params_from_numpy(jax.tree.map(
        np.asarray, JaxLM(cfg, max_pos=32).init_params(jax.random.PRNGKey(0))))
    got = main(args + ["--device", "cpu"], params=params)
    assert all(np.isfinite(got["losses"])) and len(got["ckpts"]) == 2
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=5e-2)


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_train_driver_refuses_the_embedding_families(arch):
    """The launcher's data source (``SyntheticLM``, as the reference's)
    makes only tokens: it refuses whisper and qwen2-vl, whose batches hold
    audio frames or patch embeddings, with a clear error, before it builds
    anything."""
    from repro_torch.launch.train import main

    with pytest.raises(ValueError, match="make_train_step"):
        main(["--arch", arch, "--steps", "1", "--device", "cpu"])


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embedding_families_train_through_make_train_step(arch):
    """What the launcher refuses trains through ``make_train_step``: 12 steps
    at lr 2e-3 alternating two ``make_inputs`` batches on the reduced
    config, from ``init_params``: finite losses, the last four below the
    first four on average."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models.registry import make_inputs

    model = build_model(get_arch(arch).reduced(), max_pos=64, device="cpu")
    shape = ShapeConfig("train", 64, 4, "train")
    batches = [make_inputs(model.cfg, shape, seed=i, device="cpu") for i in range(2)]
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    step = make_train_step(model, None, AdamWConfig(lr=2e-3))
    losses = []
    for i in range(12):
        params, opt, loss = step(params, opt, batches[i % 2])
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses


def test_train_driver_defaults_to_the_card():
    from repro_torch.launch.train import main

    args = ["--arch", "qwen2_0_5b", "--steps", "1", "--ckpt-every", "0"]
    if torch.cuda.is_available():
        assert np.isfinite(main(args)["losses"]).all()
    else:
        with pytest.raises(RuntimeError):
            main(args)
