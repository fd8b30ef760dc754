"""How far two correct computations of one train step fall apart at full
width: qwen2-0.5b, 2 layers, B=2 x 256, one step at lr 1e-3 from the
seeded weights and batch of ``chip_smoke.py``'s card-vs-CPU check.

Prints, leaf by leaf, the gradients', m's and v's relative L2 distances
and the share of updated parameters within 1 bf16 ulp, for the reference's
default compile and for the port on the CPU, each against the reference's
exact compile (``xla_allow_excess_precision`` off). The random weights make
the attention a hard argmax (the init's fan-in of wq and wk is H and KV,
so the scores have a std of ~170), and a one-ulp change of a bf16
projection moves a layer's gradient by tens of percent, and the gradient
norm that clips them all by several: the slice's criteria do not hold at
this configuration even between two computations of the reference. The
distances depend on the machine's CPU (its bf16 kernels round
differently).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_full_width_spread.py

It needs JAX and ~13 GiB of host memory, so it is not part of the tests.

With ``--f32`` it measures instead how far the port's step in f32 (the
bf16 weights upcast, a ``dtype="float32"`` configuration) moves when only
the CPU's thread count changes (8 against 3, so the GEMMs sum in another
order), at full width for 1 layer x 2048 tokens, 2 layers x 256 and 2
layers x 2048 (B=1): which full-width f32 step is well-conditioned enough
to hold the card to the criteria. It needs ~8 GiB and no JAX.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_train_criteria as crit  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.train.steps import loss_and_grads  # noqa: E402

LAYERS, B, S, LR, SEED = 2, 2, 256, 1e-3, 0  # chip_smoke.TRAIN_SMALL_*, TRAIN_LR, --seed


def f32_thread_spread() -> None:
    from repro_torch.tree import tree_map

    for layers, seq in ((1, 2048), (2, 256), (2, 2048)):
        cfg = dataclasses.replace(get_arch("qwen2_0_5b"), n_layers=layers)
        params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(SEED))
        params = tree_map(lambda p: p.float(), params)
        model = build_model(dataclasses.replace(cfg, dtype="float32"), device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
            vocab=cfg.vocab, seq_len=seq, global_batch=1, seed=SEED + 3)).next_batch().items()}
        seen = {}
        for threads in (8, 3):
            torch.set_num_threads(threads)
            loss, grads = loss_and_grads(model, params, batch)
            seen[threads] = (float(loss), crit.to_np(grads))
        gerr = crit.grad_errors(seen[3][1], seen[8][1])
        print(f"port in f32, {layers} layer(s) x {seq} tokens, 8 against 3 threads: loss "
              f"{seen[8][0]:.6f} / {seen[3][0]:.6f}; gradients at most {max(gerr.values()):.3e} "
              f"relative L2 ({', '.join(f'{k} {v:.1e}' for k, v in sorted(gerr.items()))})")


def main() -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jax_get_arch
    from repro.models.lm import LM as JaxLM
    from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
    from repro.train.optimizer import adamw_init as jax_adamw_init
    from repro.train.steps import make_train_step as jax_make_train_step

    cfg = dataclasses.replace(get_arch("qwen2_0_5b"), n_layers=LAYERS)
    jcfg = dataclasses.replace(jax_get_arch("qwen2_0_5b"), n_layers=LAYERS)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                   seed=SEED + 3)).next_batch()
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(SEED))
    loss, grads = loss_and_grads(model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    new, opt = adamw_update(params, grads, adamw_init(params), AdamWConfig(lr=LR))

    def to_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    jp = {k: {n: to_jax(w) for n, w in v.items()} if isinstance(v, dict) else to_jax(v)
          for k, v in params.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxLM(jcfg)
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    vg = jax.value_and_grad(lambda p, b: jm.loss_fn(p, b))
    exact_vg = jax.jit(vg).lower(jp, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    e_loss, e_grads = exact_vg(jp, jb)
    d_loss, d_grads = jax.jit(vg)(jp, jb)
    step = jax_make_train_step(jm, None, JaxAdamWConfig(lr=LR))
    o0 = jax_adamw_init(jp)
    exact = jax.jit(step).lower(jp, o0, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})(jp, o0, jb)
    default = jax.jit(step)(jp, o0, jb)
    norm = lambda g: float(np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)  # noqa: E731
                                       for x in jax.tree.leaves(g))))
    print(f"loss: exact {float(e_loss):.6f}, default {float(d_loss):.6f}, port {float(loss):.6f}; "
          f"gradient norm: exact {norm(f32(e_grads)):.4f}, default {norm(f32(d_grads)):.4f}, "
          f"port {norm(crit.to_np(grads)):.4f}")
    rows = {
        "reference default": (crit.grad_errors(f32(d_grads), f32(e_grads)),
                              crit.step_metrics(f32(default[0]), f32(default[1]),
                                                f32(exact[0]), f32(exact[1]), LR)),
        "port on the CPU": (crit.grad_errors(crit.to_np(grads), f32(e_grads)),
                            crit.step_metrics(crit.to_np(new), crit.to_np(opt),
                                              f32(exact[0]), f32(exact[1]), LR)),
    }
    for tag, (gerr, m) in rows.items():
        pooled = sum(x["within"] for x in m.values()) / sum(x["size"] for x in m.values())
        print(f"{tag} against the exact compile: gradients at most {max(gerr.values()):.4f}, "
              f"m {max(x['m'] for x in m.values()):.4f}, v {max(x['v'] for x in m.values()):.4f}, "
              f"within 1 bf16 ulp {pooled:.4f} of all parameters (least leaf "
              f"{min(x['share'] for x in m.values()):.4f}), largest |diff| / (ulp + 2 lr) "
              f"{max(x['ratio'] for x in m.values()):.4f}")
        for name in sorted(gerr):
            x = m[name]
            print(f"  {name:12s} gradient {gerr[name]:.4f} m {x['m']:.4f} v {x['v']:.4f} "
                  f"1-ulp share {x['share']:.4f}")


if __name__ == "__main__":
    f32_thread_spread() if "--f32" in sys.argv[1:] else main()
