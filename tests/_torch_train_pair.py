"""The port's training slice (reduced configs, on the CPU) against the reference:
one step of each family from the same state, shared by ``test_torch_train_pair*.py``
(each runs the tests below on its archs, through its own ``pair`` fixture).

Both packages start from the reference's parameters
(``init_params(PRNGKey(0))``, carried across with ``params_from_numpy``) and
the same ``SyntheticLM`` batch (B=2, S=64), and take one step of
``make_train_step(model, None)`` (``AdamWConfig()``: lr 3e-4), for every
family: dense (qwen2-0.5b, gemma3-1b), MoE (olmoe-1b-7b,
qwen3-moe-30b-a3b: the loss adds ``0.01 * aux``, through the backward of
the dispatch), SSM (mamba2-2.7b), hybrid (zamba2-7b: the backward of
``models/ssd.py`` and of the shared block), encoder-decoder (whisper-base:
the encoder's non-causal attention, the cross-attention and the GELU MLPs;
its unused ``wu`` gets zero gradients, as in jax) and VLM (qwen2-vl-7b:
M-RoPE and the reference's mask by the temporal positions' values). The
last two take the reference's ``make_inputs`` of a train step instead
(audio frames or embeddings and positions; seeds 0 and 1), and their 1-D
leaves (zero by the init rule) drawn from a seeded rng (std 0.1; whisper's
layer norms' weights about 1). Whisper's layer norms scale by w, not 1 + w:
from the init rule's zeros its encoder output and logits would be 0 and
only its final norm would learn.

The oracle is the reference's jitted step. XLA compiles it by default with
``xla_allow_excess_precision``, which lets a fusion skip the bf16 roundings
that the code writes between ops. The port, like the reference run op by op
(``jax.disable_jit``), rounds at every op. So each comparison is made twice:

- against the same jitted step compiled with ``xla_allow_excess_precision``
  off (``exact_jit``), at the tolerances below, on every config;
- against the default compile. On reduced gemma3-1b, olmoe, qwen3-moe and
  mamba2 that meets the same tolerances. On reduced qwen2-0.5b it does not,
  and it is as far from its own exact compile as from the port: its random
  QKV biases (std 1/sqrt(H) = 0.5) make the attention sharp, and the
  skipped roundings move the gradients by up to 9.5 % (relative L2; ``m``
  9.5 %, ``v`` 13.6 %; 3 of bq's 128 updated elements more than 1 ulp off).
  On reduced zamba2 the default compile is 104 % from its exact one in the
  gradients (``m`` 125 %, ``v`` 318 %, 86.4 % of the parameters within 1
  ulp): its sharp shared attention turns the skipped roundings into another
  step. The reference run op by op agrees with its exact compile to within
  1 % and with the port to the same degree. There the port is held to the
  default compile's own distance from the exact one, plus the tolerance.

Tolerances: the slice's acceptance criteria, in ``_torch_train_criteria``
(loss 2e-2 absolute; gradients and ``m`` 5e-2, ``v`` 1e-1 relative L2;
updated parameters within 1 bf16 ulp + 2 lr, and within 1 ulp on 98 % of
each leaf). Measured against the exact compile (loss; gradients, ``m``,
``v`` at most; parameters within 1 ulp): qwen2 5e-7; 9.6e-3, 9.6e-3,
2.0e-2; 99.96 %. gemma3 0; 1.4e-2, 1.4e-2, 1.7e-2; 99.93 %. olmoe 0;
1.4e-2, 1.4e-2, 1.9e-2; 99.94 %. qwen3-moe 1.0e-5; 1.3e-2, 1.3e-2,
2.3e-2; 99.93 %. mamba2 3.1e-5; 3.9e-3, 3.9e-3, 7.9e-3; 99.99 %. zamba2
2.8e-4; 3.1e-2, 3.1e-2, 3.7e-2; 99.64 %. whisper 9.5e-7; 4.3e-2, 4.2e-2,
6.5e-2; 99.91 % (the encoder's small gradients, which reach the loss only
through the cross-attention, sum terms that cancel: its default compile is
15.4 % from the exact one). qwen2-vl 4.8e-7; 1.3e-2, 1.2e-2, 1.8e-2;
99.96 % (like qwen2, its random QKV biases put the default compile 17.3 %
from the exact one). Both are held to the default compile's distance plus
the tolerance there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models import ssd as jax_ssd
from repro.models.lm import LM as JaxLM
from repro.models.registry import make_inputs as jax_make_inputs
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import SyntheticLM as JaxSyntheticLM
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import loss_and_grads, make_train_step
from repro_torch.tree import named_leaves

from _torch_encdec import norm_draw  # noqa: I001  (tests/ helper)
from _torch_train_criteria import (  # noqa: I001  (tests/ helper)
    GRAD_RTOL,
    LOSS_ATOL,
    assert_step_close,
    hold_step,
    meets,
    rel_l2,
    step_metrics,
    to_np,
)

EMBED_ARCHS = ["whisper_base", "qwen2_vl_7b"]  # batches of audio frames, patch embeddings
B, S = 2, 64
LR = AdamWConfig().lr


def exact_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


class TrainPair:
    """One reduced arch on both sides: the reference's parameters, one batch,
    the loss, gradients and one step of each package."""

    def __init__(self, arch: str):
        self.cfg = jax_get_arch(arch).reduced()
        jm = JaxLM(self.cfg)
        self.jm = jm
        self.jp = jm.init_params(jax.random.PRNGKey(0))
        if arch in EMBED_ARCHS:
            # the init rule's zero 1-D leaves perturbed, as in test_torch_models:
            # whisper's layer norms scale by w (not 1 + w), so from zeros its
            # encoder output and logits would be 0 and only the final norm learn
            self.jp = _perturb_1d(self.jp, np.random.default_rng(1), self.cfg.family == "encdec")
        self.np_params = jax.tree.map(np.asarray, self.jp)
        if arch in EMBED_ARCHS:
            # the reference's make_inputs of a B x S train step (audio frames and
            # tokens, or embeddings and M-RoPE positions drawn in [0, S); labels)
            self.batches = [{k: np.asarray(v) for k, v in jax_make_inputs(
                self.cfg, JaxShapeConfig("train", S, B, "train"), seed=i).items()}
                for i in range(2)]
        else:
            data = JaxSyntheticLM(JaxDataConfig(vocab=self.cfg.vocab, seq_len=S, global_batch=B))
            self.batches = [data.next_batch(), data.next_batch()]
        jb = {k: jnp.asarray(v) for k, v in self.batches[0].items()}
        vg = jax.value_and_grad(lambda p, b: jm.loss_fn(p, b))
        self.j_loss_exact, self.j_grads_exact = exact_jit(vg, self.jp, jb)
        self.j_loss, self.j_grads = jax.jit(vg)(self.jp, jb)
        step = jax_make_train_step(jm, None)
        o0 = jax_adamw_init(self.jp)
        self.j_step_exact = exact_jit(step, self.jp, o0, jb)
        self.j_step = jax.jit(step)(self.jp, o0, jb)

        self.tm = build_model(get_arch(arch).reduced(), device="cpu")
        self.tp = params_from_numpy(self.np_params)
        tb = self.torch_batch(0)
        self.t_loss, self.t_grads = loss_and_grads(self.tm, self.tp, tb)
        self.t_step = make_train_step(self.tm)(self.tp, adamw_init(self.tp), tb)

    def torch_batch(self, i: int) -> dict:
        return {k: tensor_from_numpy(v) for k, v in self.batches[i].items()}


def _perturb_1d(tree, rng, one: bool = False):
    """The 1-D leaves drawn from ``rng``: std 0.1 about 0, or with ``one``
    about 1 for the layer norms' weights (``*_ln``: a layer norm's usual
    start is weight 1, bias 0)."""
    return {k: _perturb_1d(v, rng, one) if isinstance(v, dict)
            else jnp.asarray(norm_draw(rng, v.shape, one and k.endswith("ln")), v.dtype)
            if v.ndim == 1 else v
            for k, v in tree.items()}


def _default_is_exact(pair: TrainPair) -> bool:
    """Whether the default compile meets the criteria against the exact one
    (gemma3: yes; qwen2: no, see the module's docstring)."""
    return meets(step_metrics(*_np_step(pair.j_step_exact), *_np_step(pair.j_step), LR))


def _np_step(step):
    p, o = step[0], step[1]
    if isinstance(next(iter(jax.tree.leaves(p))), torch.Tensor):
        return to_np(p), to_np(o)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p), jax.tree.map(np.asarray, o)


def test_loss_matches_reference(pair):
    assert pair.t_loss.dtype == torch.float32 and pair.t_loss.shape == ()
    assert abs(float(pair.t_loss) - float(pair.j_loss_exact)) <= LOSS_ATOL
    assert abs(float(pair.t_loss) - float(pair.j_loss)) <= LOSS_ATOL


def test_grads_match_reference(pair):
    want_exact = dict(named_leaves(jax.tree.map(np.asarray, pair.j_grads_exact)))
    want = dict(named_leaves(jax.tree.map(np.asarray, pair.j_grads)))
    got = dict(named_leaves(pair.t_grads))
    assert got.keys() == want.keys()
    exact = _default_is_exact(pair)
    for name, g in got.items():
        assert g.dtype == dict(named_leaves(pair.tp))[name].dtype
        assert g.shape == want[name].shape
        g = g.float().numpy()
        assert rel_l2(g, want_exact[name]) <= GRAD_RTOL, name
        floor = 0.0 if exact else rel_l2(want_exact[name], want[name])
        assert rel_l2(g, want[name]) <= floor + GRAD_RTOL, name


def test_train_step_matches_reference(pair):
    tp, to, tl = pair.t_step
    assert abs(float(tl) - float(pair.j_step_exact[2])) <= LOSS_ATOL
    assert int(to["step"]) == int(pair.j_step[1]["step"]) == 1 and to["step"].dtype == torch.int32
    for name, value in named_leaves(tp):
        assert value.dtype == dict(named_leaves(pair.tp))[name].dtype
    got = _np_step((tp, to))
    assert_step_close(step_metrics(*got, *_np_step(pair.j_step_exact), LR))
    floor = None if _default_is_exact(pair) else step_metrics(
        *_np_step(pair.j_step_exact), *_np_step(pair.j_step), LR)
    assert_step_close(step_metrics(*got, *_np_step(pair.j_step), LR), floor)


def test_second_step_from_the_carried_state(pair, monkeypatch):
    """The reference's state after its (exact) first step carried across
    bit for bit (f32 moments, int32 step, bf16 and f32 parameters), then a
    second step on both sides with the next batch, where Adam's update is no
    longer a sign: the same criteria against the exact compile, but for the
    1-ulp share, taken over all parameters (measured 0.9997 on both).
    Leaf by leaf it can fall short on a small leaf: an element whose first
    two gradients nearly cancel in ``m`` moves by a different fraction of lr
    (2 of reduced qwen2's 64 ``bk`` elements, within 0.37 of ulp + 2 lr).

    Where the model has an SSD (mamba2, zamba2), the reference's own exact
    step with every SSD output moved one f32 ulp up, or down
    (``_ssd_nudged_step``), decides how the step is held (``hold_step``,
    the policy the card's checks keep): that flips a few bf16 roundings, as
    any other correct order of the SSD's f32 sums does. Here the step must
    be held. At these parameters reduced zamba2 is ill-conditioned: its
    shared attention is sharp, and the nudge up moves the reference's ``m``
    by up to 16.4 % (``shared.ln2``; ``v`` 20.2 %: 3.27 tolerances, within
    the cap of 4), the port's step is 16.6 % from it (``v`` 16.6 %), held
    to the criteria widened by that distance. mamba2: the nudge down moves
    ``m`` by 0.25 %, within the criteria, so they are not widened."""
    jp1, jo1, _ = pair.j_step_exact
    np_p, np_o = jax.tree.map(np.asarray, jp1), jax.tree.map(np.asarray, jo1)
    tp1, to1 = params_from_numpy(np_p), params_from_numpy(np_o)
    assert to1["step"].dtype == torch.int32 and to1["step"].shape == () and int(to1["step"]) == 1
    for tree, src in ((tp1, np_p), (to1["m"], np_o["m"]), (to1["v"], np_o["v"])):
        for name, value in named_leaves(tree):
            arr = dict(named_leaves(src))[name]
            assert value.dtype in (torch.float32, torch.bfloat16)
            np.testing.assert_array_equal(value.view(torch.int16 if value.dtype == torch.bfloat16
                                                     else torch.int32).numpy(),
                                          arr.view(np.int16 if value.dtype == torch.bfloat16
                                                   else np.int32))
    jb = {k: jnp.asarray(v) for k, v in pair.batches[1].items()}
    want = exact_jit(jax_make_train_step(pair.jm, None), jp1, jo1, jb)
    got = make_train_step(pair.tm)(tp1, to1, pair.torch_batch(1))
    assert abs(float(got[2]) - float(want[2])) <= LOSS_ATOL
    assert int(got[1]["step"]) == 2
    nudged = [(step_metrics(*_np_step(_ssd_nudged_step(pair, (jp1, jo1, jb), to, monkeypatch)),
                            *_np_step(want), LR), None)
              for to in ((np.inf, -np.inf) if pair.cfg.is_ssm else ())]
    held, verdict, failures = hold_step(step_metrics(*_np_step(got), *_np_step(want), LR),
                                        nudged=nudged, pooled=True)
    assert held and not failures, (verdict, failures)


def _ssd_nudged_step(pair: TrainPair, args: tuple, to: float, monkeypatch):
    """The reference's exact step with every ``_ssd_chunked`` output moved
    one f32 ulp toward ``to`` (the gradient passes through unchanged)."""
    real = jax_ssd._ssd_chunked

    def nudged(*a, **kw):
        y = real(*a, **kw)
        ys = jax.lax.stop_gradient(y)
        return y + (jnp.nextafter(ys, jnp.asarray(to, y.dtype)) - ys)

    with monkeypatch.context() as m:
        m.setattr(jax_ssd, "_ssd_chunked", nudged)
        return exact_jit(jax_make_train_step(pair.jm, None), *args)
