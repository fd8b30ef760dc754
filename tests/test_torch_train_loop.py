"""The port's train step over several steps (reduced configs, on the CPU): the
served parameters left alone, and the loss falling over 12 steps for the
dense, MoE, SSM and hybrid families (the reference's
``test_train_loop_reduces_loss``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models.registry import build_model
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step
from repro_torch.tree import named_leaves


def test_train_step_leaves_the_served_parameters_alone():
    """Parameters registered for serving (``load_params``: frozen) are not
    modified, and stay frozen, by a train step."""
    model = build_model(get_arch("qwen2_0_5b").reduced(), device="cpu")
    params = model.load_params(model.init_params(torch.Generator().manual_seed(0)))
    before = {n: v.clone() for n, v in named_leaves(params)}
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        vocab=model.cfg.vocab, seq_len=32, global_batch=2)).next_batch().items()}
    new, opt, loss = make_train_step(model)(params, adamw_init(params), batch)
    for name, value in named_leaves(params):
        assert not value.requires_grad and torch.equal(value, before[name])
    assert not any(torch.equal(v, before[n]) for n, v in named_leaves(new) if v.ndim >= 2)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmoe_1b_7b", "qwen3_moe_30b_a3b", "mamba2_2_7b",
                                  "zamba2_7b"])
def test_train_loop_reduces_loss(arch):
    """12 steps at lr 2e-3 on the reduced config (the reference's
    ``test_train_loop_reduces_loss``, which trains qwen2, olmoe and
    mamba2): finite losses, the last four below the first four on average."""
    model = build_model(get_arch(arch).reduced(), max_pos=64, device="cpu")
    data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=64, global_batch=4, seed=0))
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    step = make_train_step(model, None, AdamWConfig(lr=2e-3))
    losses = []
    for _ in range(12):
        batch = {k: torch.from_numpy(v) for k, v in data.next_batch().items()}
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
    assert int(opt["step"]) == 12
