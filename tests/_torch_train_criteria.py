"""The criteria one train step is held to against another (JAX-free, so the
card's tests and ``chip_smoke.py`` use them too).

- loss within 2e-2 absolute;
- each gradient leaf within 5e-2 relative L2 error (bf16 gradients, summed
  in another order);
- after the step each ``m`` leaf within 5e-2 and each ``v`` leaf within 1e-1
  relative L2 (``v`` squares the gradient's error); ``step`` equal;
- every updated parameter within 1 bf16 ulp of itself plus 2 lr of the
  other's, and within 1 ulp on at least 98 % of each leaf's elements:
  Adam's first step moves each parameter by +-lr wherever |g| >> eps, so an
  element whose gradient is near 0 can move the other way (2 lr apart).
"""
import numpy as np
import torch

from repro_torch.tree import named_leaves

LOSS_ATOL, GRAD_RTOL, M_RTOL, V_RTOL, ULP_SHARE = 2e-2, 5e-2, 5e-2, 1e-1, 0.98


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def to_np(tree):
    """A nested dict of tensors (any device) as numpy, bf16 as f32."""
    return {k: to_np(v) if isinstance(v, dict)
            else (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in tree.items()}


def grad_errors(got: dict, want: dict) -> dict:
    """Each gradient leaf's relative L2 error (trees as numpy)."""
    want = dict(named_leaves(want))
    return {name: rel_l2(g, want[name]) for name, g in named_leaves(got)}


def step_metrics(got_p, got_o, want_p, want_o, lr: float) -> dict:
    """Per-leaf distances of one step's (params, opt state) from another's
    (trees as numpy): m and v relative L2, the share of parameters within
    1 bf16 ulp, and the largest |diff| / (ulp + 2 lr)."""
    out = {}
    tp, wp = dict(named_leaves(got_p)), dict(named_leaves(want_p))
    tm, wm = dict(named_leaves(got_o["m"])), dict(named_leaves(want_o["m"]))
    tv, wv = dict(named_leaves(got_o["v"])), dict(named_leaves(want_o["v"]))
    for name in wp:
        a = np.asarray(tp[name], np.float32)
        b = np.asarray(wp[name], np.float32)
        d = np.abs(a - b)
        ulp = bf16_ulp(b)
        out[name] = {"m": rel_l2(tm[name], wm[name]), "v": rel_l2(tv[name], wv[name]),
                     "share": float(np.mean(d <= ulp)), "within": int(np.sum(d <= ulp)),
                     "size": d.size, "ratio": float(np.max(d / (ulp + 2 * lr)))}
    return out


def assert_step_close(got: dict, floor: dict | None = None, pooled: bool = False) -> None:
    """``got`` (``step_metrics``) meets the criteria; with ``floor`` (the
    same metrics of one reference against another), each criterion is
    widened by that distance. ``pooled`` takes the 1-ulp share over all
    parameters instead of leaf by leaf."""
    for name, g in got.items():
        f = floor[name] if floor else {"m": 0.0, "v": 0.0, "share": 1.0}
        assert g["m"] <= f["m"] + M_RTOL, (name, g, f)
        assert g["v"] <= f["v"] + V_RTOL, (name, g, f)
        assert pooled or g["share"] >= f["share"] - (1 - ULP_SHARE), (name, g, f)
        assert g["ratio"] <= max(1.0, f.get("ratio", 0.0)), (name, g, f)
    share = sum(g["within"] for g in got.values()) / sum(g["size"] for g in got.values())
    assert share >= ULP_SHARE, share
