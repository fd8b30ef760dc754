"""Route-level criteria for the MoE family on two devices, shared by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (which imports this file
from ``tests/``). Routing is discontinuous: router logits a few ulps apart
can swap one of a token's experts where two of them nearly tie, and one
swap changes its experts' group sizes and so which assignments the
capacity drops. So the two sides are held to:

- every token's expert set agrees wherever the reference side's margin is
  at least ROUTE_DELTA, at every token whose earlier layers agreed (a swap
  upstream changes the token's input downstream). The margin is the k-th
  minus the (k+1)-th router log-probability, i.e. the difference of the
  two router logits that decide the route. It is taken in logits, not
  probabilities, because what moves it is a perturbation of the logits:
  at E = 64 the probabilities at the boundary sit near 1/64, at the
  reduced configs' E = 4 near 1/4, so one probability margin would be
  too loose at one width or too tight at the other;
- which assignments are dropped agrees in every layer in which no expert
  set differs;
- values are compared at the tokens (or sequences) whose routes, expert
  sets and drops, agreed in every layer.

Every disagreement is counted and returned for printing, never absorbed
into a looser tolerance.

``ep_moe``/``ep_emulated`` emulate the expert-parallel branch on one
process, the counterpart of the sharded prefill for
``tests/test_torch_mesh_tp.py`` and ``chip_smoke.py``'s phase 9.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

# About 2x the largest margin shift between the card and the CPU at tokens
# whose routes agreed, as chip_smoke.py prints it: 0.0389 (olmoe-1b-7b, full
# width, 2 layers, on an H100; 1.7e-6 for moe_layer alone on identical
# inputs). Upstream of the router, the card's flash kernel rounds P to bf16
# (within 2e-2 of its plain version), which moves the router's input.
ROUTE_DELTA = 0.08


def bf16_ulp(a) -> np.ndarray:
    """The bf16 spacing at |a| (8 significant bits)."""
    m = np.maximum(np.abs(np.asarray(a, np.float32)), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(m)) - 7)


def row_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over rows (all but the last dim), of a row's max |got -
    want| in bf16 ulps of the row's largest |want|: a limit that scales with
    what is compared, where outputs of an attention over many keys are far
    below 1. NaN where ``got`` is not finite."""
    g, w = got.float(), want.float()
    m = w.abs().amax(-1).clamp_min(2.0**-126)
    return float(((g - w).abs().amax(-1) / torch.exp2(torch.floor(torch.log2(m)) - 7)).max())


def ep_moe(x, wr, w_gate, w_up, w_down, *, top_k: int, capacity_factor: float,
           n_batch: int, n_model: int):
    """``moe_layer``'s expert-parallel branch on an (n_batch, n_model) mesh,
    emulated on one process from the whole x (B, S, D) and the whole expert
    weights: each (batch block, sequence block) routed alone, the buffers'
    blocks exchanged and read back as the reference reads them, the aux
    loss averaged over the blocks."""
    from repro_torch.models.layers import _capacity, _combine, _contrib, _dispatch, _experts, _route

    Bw, Sw, D = x.shape
    E = wr.shape[1]
    El, Bl, Sl = E // n_model, Bw // n_batch, Sw // n_model
    C = _capacity(Bl * Sl, top_k, E, capacity_factor)
    rows, aux = [], []
    for d in range(n_batch):
        xts = [x[d * Bl:(d + 1) * Bl, m * Sl:(m + 1) * Sl].reshape(-1, D) for m in range(n_model)]
        routes = [_route(xt, wr, top_k=top_k, capacity=C) for xt in xts]
        sent = [_dispatch(xt, r, E * C).reshape(n_model, El * C, D) for xt, r in zip(xts, routes)]
        done = []
        for m in range(n_model):  # rank m's experts, on what every rank sent it
            recv = torch.cat([sent[p][m] for p in range(n_model)])
            ws = (w[m * El:(m + 1) * El] for w in (w_gate, w_up, w_down))
            done.append(_experts(recv.reshape(El, n_model * C, D), *ws).reshape(n_model, -1, D))
        ys = []
        for m, (xt, r) in enumerate(zip(xts, routes)):
            back = torch.cat([done[p][m] for p in range(n_model)])
            ys.append(_combine(_contrib(back, r, x.dtype), r.st, r.se, xt.shape[0], E)
                      .reshape(Bl, Sl, D))
            aux.append(E * torch.sum(r.me * r.ce))
        rows.append(torch.cat(ys, dim=1))
    return torch.cat(rows), torch.stack(aux).mean()


@contextlib.contextmanager
def ep_emulated(n_batch: int, n_model: int):
    """While active, the LM's MoE layers with S > 1 run ``ep_moe``: the
    single-device counterpart of the sharded expert-parallel prefill."""
    from repro_torch.models import lm

    real = lm.moe_layer

    def moe(x, *a, ctx=None, **kw):
        if x.shape[1] == 1:
            return real(x, *a, **kw)
        return ep_moe(x, *a, n_batch=n_batch, n_model=n_model, **kw)

    lm.moe_layer = moe
    try:
        yield
    finally:
        lm.moe_layer = real


class RouteLog:
    """While active, records every call of the port's routing function
    (``repro_torch.models.layers._route``: one per MoE layer) as host numpy:
    ``probs`` (T, E) f32, and ``routed`` and ``kept`` (T, E) bool."""

    def __init__(self):
        self.calls: list[dict] = []

    def __enter__(self) -> RouteLog:
        from repro_torch.models import layers

        self._layers, self._orig = layers, layers._route

        def recorded(xt, wr, **kw):
            r = self._orig(xt, wr, **kw)
            self.calls.append(_to_host(r))
            return r

        layers._route = recorded
        return self

    def __exit__(self, *exc) -> None:
        self._layers._route = self._orig


class RouteReplay:
    """While active, the port's top-k (``repro_torch.models.layers._top_k``)
    takes, call by call, the expert sets of a recorded run (``RouteLog.calls``,
    in their order) instead of its own k largest probabilities; the gates
    are still this run's probabilities at those experts, in descending
    order. This run then routes, drops and combines as the recorded one
    did, so two devices' steps stay comparable where a near-tie flipped a
    route."""

    def __init__(self, calls: list[dict]):
        self.calls = calls

    def __enter__(self) -> RouteReplay:
        from repro_torch.models import layers

        self._layers, self._orig = layers, layers._top_k
        recorded = iter(self.calls)

        def replayed(probs, k):
            routed = torch.from_numpy(next(recorded)["routed"]).to(probs.device)
            idx = routed.nonzero()[:, 1].reshape(-1, k)  # each token's k experts, ascending
            vals = probs.gather(-1, idx)
            order = torch.sort(vals.detach(), dim=-1, descending=True, stable=True)[1]
            return vals.gather(-1, order), idx.gather(-1, order)

        layers._top_k = replayed
        return self

    def __exit__(self, *exc) -> None:
        self._layers._top_k = self._orig


def _to_host(r) -> dict:
    T, E = r.probs.shape
    routed = torch.zeros((T, E), dtype=torch.bool, device=r.st.device)
    routed[r.st, r.se] = True
    kept = torch.zeros_like(routed)
    kept[r.st, r.se] = r.keep
    return {"probs": r.probs.detach().float().cpu().numpy(), "routed": routed.cpu().numpy(),
            "kept": kept.cpu().numpy()}


def _log(probs: np.ndarray) -> np.ndarray:
    return np.log(np.maximum(probs, np.float32(1e-38)))


def margins(probs: np.ndarray, k: int) -> np.ndarray:
    """Each token's k-th minus (k+1)-th largest router log-probability."""
    top = -np.sort(-_log(probs), axis=-1)
    return top[:, k - 1] - top[:, k]


def margin_shift(test: np.ndarray, ref: np.ndarray, k: int) -> np.ndarray:
    """How far ``test`` moves each token's margin between ``ref``'s k-th and
    (k+1)-th experts (log-probabilities): what a flip has to overcome."""
    order = np.argsort(-ref, axis=-1, kind="stable")[:, k - 1:k + 1]
    la, lb = (np.take_along_axis(_log(p), order, axis=-1) for p in (test, ref))
    return (la[:, 0] - la[:, 1]) - (lb[:, 0] - lb[:, 1])


def compare_routes(test: list[dict], ref: list[dict], k: int, n_seq: int,
                   delta: float = ROUTE_DELTA) -> dict:
    """The routes of ``test`` against ``ref`` (``RouteLog.calls`` of one run
    each, layer by layer; ``ref``'s margins decide), over T tokens that
    form ``n_seq`` equal sequences. Raises AssertionError where the criteria
    above fail. Returns {"layers": per-layer counts, "agree": (T,) bool,
    tokens whose routes agreed in every layer, "seqs": the sequences all of
    whose tokens agree, "max_shift": the largest ``margin_shift`` at tokens
    whose routes agreed in this and every earlier layer}."""
    if len(test) != len(ref) or not ref:
        raise AssertionError(f"{len(test)} routed layers against {len(ref)}")
    T = ref[0]["probs"].shape[0]
    clean = np.ones(T, dtype=bool)
    layers, max_shift = [], 0.0
    for i, (a, b) in enumerate(zip(test, ref)):
        m = margins(b["probs"], k)
        sets = (a["routed"] != b["routed"]).any(-1)
        drops = (a["kept"] != b["kept"]).any(-1) & ~sets
        same = clean & ~sets
        if same.any():
            shift = margin_shift(a["probs"], b["probs"], k)[same]
            max_shift = max(max_shift, float(np.abs(shift).max()))
        bad = sets & clean & (m >= delta)
        if bad.any():
            raise AssertionError(f"layer {i}: expert sets differ at {int(bad.sum())} tokens with "
                                 f"margins {m[bad][:8]} >= {delta}")
        if drops.any() and not sets.any():
            raise AssertionError(f"layer {i}: drops differ at {int(drops.sum())} tokens, but no "
                                 "expert set does")
        layers.append({"near_ties": int((m < delta).sum()),
                       "flips_below_delta": int((sets & clean).sum()),
                       "flips_after_upstream_flip": int((sets & ~clean).sum()),
                       "drop_changes": int(drops.sum()), "min_margin": float(m.min())})
        clean &= ~(sets | drops)
    per_seq = clean.reshape(n_seq, T // n_seq).all(-1)
    return {"layers": layers, "agree": clean, "seqs": np.flatnonzero(per_seq).tolist(),
            "max_shift": max_shift}
