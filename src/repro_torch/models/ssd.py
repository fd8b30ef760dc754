"""Mamba2 / SSD mixer (state-space duality, arXiv:2405.21060): the port of
the reference's ``repro.models.ssd``.

Chunked SSD: the sequence is cut into Q-long chunks. The quadratic
intra-chunk term and each chunk's contribution to the state are computed
for every chunk at once (batched f32 matmuls); only the (B, G, Hg, N, P)
state runs through a loop over the chunks, where the reference carries it
through a ``lax.scan``. The math per element is the reference's, with the
same pairing of its three-operand einsums (dt x first, then the sum over
keys; C against the state first, then the decay). Decode is the plain SSM
recurrence: one state update per token.

Precision, as in the reference: bf16 projections; the causal conv
accumulates in f32 and rounds to bf16 before an f32 silu that rounds to
bf16 again; dt, A, the SSD and the state in f32; the gated RMSNorm over
d_inner scales by ``1 + norm``. The reference computes the SSD with XLA
einsums outside any Pallas kernel, so plain f32 matmuls are its port here
(with TF32 off, as ``chip_smoke.py`` sets it).

With a ``MeshCtx`` whose "model" axis is larger than 1 (``tp``) the mixer
runs on this rank's SSM heads (the reference's head parallelism): ``wz``,
``wx``, ``wdt``, ``norm`` and ``wo`` are the rank's blocks of ``d_inner`` or
of the heads; ``dt_bias``, ``A_log``, ``Dskip`` and ``conv_w``, replicated,
are cut to the rank's heads and channels (its ``x`` channels and the shared
B and C); the gated RMSNorm's mean over ``d_inner`` sums its squares over
"model"; the output is the out-projection's partial sums.

With a ``MeshCtx`` whose batch axes shard the sequence (``sp``: a batch
that does not fill them), the mixer runs on this rank's block of the
sequence. The causal conv reads the previous rank's last K - 1 rows of its
input (``MeshCtx.halo``; zeros on the first rank) where the whole sequence
pads zeros, and the carried state crosses the ranks by a relay
(``MeshCtx.relay_in``/``relay_out``): each rank computes its chunks' own
contributions and decays at once, receives the state entering its first
chunk from the previous rank, runs its share of the same loop over the
chunks and passes its last state on, one (B, G, Hg, N, P) f32 state a hop.
Both run the same operations on the same values as the whole sequence's
mixer, so the rank's rows equal its rows bit for bit. Both are
differentiable (``models/sharding.py``): in training the gradient of the
halo's rows goes back to the previous rank, and the entering state's
gradient is relayed back in reverse sequence order, one state a hop.

Parameter layout per layer (the caller stacks a leading L axis):
  wz, wx (D, d_inner) | wB, wC (D, G*N) | wdt (D, H) | dt_bias (H,)
  A_log (H,) | Dskip (H,) | conv_w (K, conv_dim) | norm (d_inner,)
  wo (d_inner, D)        with conv_dim = d_inner + 2*G*N, G = 1 group.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from typing import TYPE_CHECKING

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import NEG, dt

if TYPE_CHECKING:
    from repro_torch.models.sharding import MeshCtx

G = 1  # B/C groups (mamba2 default ngroups=1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)) at every x (``F.softplus`` switches to x above 20 and
    takes another formula below)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 before: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d: u (B, L, C), w (K, C) -> (B, L, C): K
    shifted products added in f32 in the order j = 0..K-1, cast to u's
    dtype. ``before`` (B, K-1, C) holds the K - 1 rows before u (a
    sequence rank's halo), zeros where None."""
    K, L = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0)) if before is None else torch.cat([before, u], dim=1)
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for j in range(K):
        out = out + pad[:, j:j + L].float() * w[j].float()
    return out.to(u.dtype)


def _in_proj(p: dict, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """z, xBC = [x W_x, x W_B, x W_C] and dt_raw: the bf16 projections of x (..., D)."""
    z = x @ p["wz"]
    xbc = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], dim=-1)
    return z, xbc, x @ p["wdt"]


def _local(p: dict, cfg: ArchConfig, tp: "MeshCtx | None") -> tuple[dict, int, int]:
    """The per-head leaves ``dt_bias``, ``A_log``, ``Dskip`` and the conv's
    weights cut to this rank's heads and channels (``p`` itself without
    ``tp``), with the rank's head and ``d_inner`` counts."""
    if tp is None:
        return p, cfg.ssm_heads, cfg.d_inner
    n, r = tp.n_model, tp.model_rank
    H, d_in = cfg.ssm_heads // n, cfg.d_inner // n
    out = dict(p)
    for name in ("dt_bias", "A_log", "Dskip"):
        out[name] = p[name].narrow(0, r * H, H)
    out["conv_w"] = p["conv_w"][:, _channels(cfg, tp, p["conv_w"].device)]
    return out, H, d_in


def _channels(cfg: ArchConfig, tp: "MeshCtx", device: torch.device) -> torch.Tensor:
    """This rank's channels of the conv: its block of the x channels, then
    the B and C channels every rank uses."""
    d_in = cfg.d_inner // tp.n_model
    mine = torch.arange(tp.model_rank * d_in, (tp.model_rank + 1) * d_in, device=device)
    shared = torch.arange(cfg.d_inner, cfg.d_inner + 2 * G * cfg.ssm_state, device=device)
    return torch.cat([mine, shared])


def mamba2_mixer(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 tp: "MeshCtx | None" = None, sp: "MeshCtx | None" = None) -> torch.Tensor:
    """x (B, L, D) -> (B, L, D). Chunked SSD over the full sequence. With
    ``tp``, on this rank's heads: the out-projection's partial sums. With
    ``sp``, x is this rank's block of a sequence sharded over the batch
    axes (module docstring): L must be a multiple of the chunk."""
    B, L, D = x.shape
    P, N = cfg.ssm_headdim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, L) if sp is None else cfg.ssm_chunk
    if L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the chunk {Q}"
                         + (f" (this rank's block of a sequence of {L * sp.n_batch} sharded "
                            f"over {sp.n_batch} ranks)" if sp is not None else ""))
    p, H, d_in = _local(p, cfg, tp)
    z, xbc, dt_raw = _in_proj(p, x)
    before = None if sp is None else sp.halo(xbc, p["conv_w"].shape[0] - 1)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], before).float()).to(x.dtype)
    xin, Bp, Cp = xbc[..., :d_in], xbc[..., d_in:d_in + G * N], xbc[..., d_in + G * N:]

    dt_ = softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B, L, H, P)
    y = _ssd_chunked(xh, dt_, A, Bp.reshape(B, L, G, N), Cp.reshape(B, L, G, N), Q, sp)
    y = y + xh.float() * p["Dskip"].float()[None, None, :, None]
    y = y.reshape(B, L, d_in).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    return _gated_norm(y, p["norm"], cfg.norm_eps, tp).to(x.dtype) @ p["wo"]


def _gated_norm(y: torch.Tensor, norm: torch.Tensor, eps: float,
                tp: "MeshCtx | None" = None) -> torch.Tensor:
    """RMSNorm over d_inner in f32, scaled by ``1 + norm``. With ``tp`` y is
    this rank's block of d_inner: the f32 sum of squares is summed over
    "model"."""
    y32 = y.float()
    if tp is None:
        ms = (y32 * y32).mean(dim=-1, keepdim=True)
    else:
        ms = tp.psum_model((y32 * y32).sum(dim=-1, keepdim=True)) / (y.shape[-1] * tp.n_model)
    return y32 * torch.rsqrt(ms + eps) * (1.0 + norm.float())


def _ssd_chunked(x: torch.Tensor, dt_: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, Q: int, sp: "MeshCtx | None" = None) -> torch.Tensor:
    """Minimal SSD. x (B, L, H, P) bf16 or f32, dt (B, L, H) f32, A (H,),
    Bm/Cm (B, L, G, N). Returns y (B, L, H, P) f32. With ``sp`` the
    sequence rank's block, its entering state relayed (``_inter_chunk``)."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    nC, Hg = L // Q, H // G
    xc = x.reshape(B, nC, Q, G, Hg, P).float()
    dtc = dt_.reshape(B, nC, Q, G, Hg)
    Bc = Bm.reshape(B, nC, Q, G, N).float()
    Cc = Cm.reshape(B, nC, Q, G, N).float()
    cum = torch.cumsum(dtc * A.reshape(1, 1, 1, G, Hg), dim=2)  # running log-decay, <= 0
    y = _intra_chunk(xc, dtc, Bc, Cc, cum) + _inter_chunk(xc, dtc, Bc, Cc, cum, sp)
    return y.reshape(B, L, G * Hg, P)


def _intra_chunk(xc: torch.Tensor, dtc: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                 cum: torch.Tensor) -> torch.Tensor:
    """The quadratic term of every chunk at once: y[q] = sum over k <= q of
    (C_q . B_k) exp(cum_q - cum_k) dt_k x_k, laid out (B, nC, G, Hg, Q, K)
    for the product. Masked BEFORE the exp: above the diagonal the segment
    sum is large and positive, and exp would overflow. -> (B, nC, Q, G, Hg, P)."""
    Q = xc.shape[2]
    scores = Cc.permute(0, 1, 3, 2, 4) @ Bc.permute(0, 1, 3, 4, 2)   # (B, nC, G, Q, K)
    cum_t = cum.permute(0, 1, 3, 4, 2)                               # (B, nC, G, Hg, Q)
    seg = cum_t[..., :, None] - cum_t[..., None, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    M = scores[:, :, :, None] * torch.exp(torch.where(causal, seg, NEG))
    dx = (dtc[..., None] * xc).permute(0, 1, 3, 4, 2, 5)             # (B, nC, G, Hg, K, P)
    return (M @ dx).permute(0, 1, 4, 2, 3, 5)


def _inter_chunk(xc: torch.Tensor, dtc: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                 cum: torch.Tensor, sp: "MeshCtx | None" = None) -> torch.Tensor:
    """The carried state's term: each chunk's own contribution to the state
    (every chunk at once), the state entering each chunk (the one loop over
    chunks), and y[q] = (C_q . state) exp(cum_q). -> (B, nC, Q, G, Hg, P).
    With ``sp`` the loop starts from the state the previous sequence rank
    ended with and passes this rank's last state on (the relay: one state a
    hop, not every chunk's)."""
    B, nC, Q, G_, Hg, P = xc.shape
    N = Bc.shape[-1]
    # s_new[n, p] = sum_k B[k, n] (dt_k exp(cum_end - cum_k) x_k)[p]
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)                   # (B, nC, Q, G, Hg)
    w = (dtc * decay_to_end)[..., None] * xc                         # (B, nC, K, G, Hg, P)
    w = w.permute(0, 1, 3, 2, 4, 5).reshape(B, nC, G_, Q, Hg * P)
    s_new = (Bc.permute(0, 1, 3, 4, 2) @ w).reshape(B, nC, G_, N, Hg, P)
    s_new = s_new.permute(0, 1, 2, 4, 3, 5)                          # (B, nC, G, Hg, N, P)
    chunk_decay = torch.exp(cum[:, :, -1])[..., None, None]          # (B, nC, G, Hg, 1, 1)
    state = torch.zeros((B, G_, Hg, N, P), dtype=torch.float32, device=xc.device)
    if sp is not None:
        # the received state's gradient leaves before s_new's (and the halo's) backward
        state = sp.relay_in(state, after=s_new)
    entering = []
    for c in range(nC):
        entering.append(state)
        state = chunk_decay[:, c] * state + s_new[:, c]
    states = torch.stack(entering, dim=1)                             # (B, nC, G, Hg, N, P)
    states = states.permute(0, 1, 2, 4, 3, 5).reshape(B, nC, G_, N, Hg * P)
    cs = (Cc.permute(0, 1, 3, 2, 4) @ states).reshape(B, nC, G_, Q, Hg, P)
    y = cs.permute(0, 1, 3, 2, 4, 5) * torch.exp(cum)[..., None]
    return y if sp is None else sp.relay_out(state, y)


def mamba2_decode_step(p: dict, x: torch.Tensor, conv_state: torch.Tensor,
                       ssm_state: torch.Tensor, cfg: ArchConfig, tp: "MeshCtx | None" = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrence. x (B, D); conv_state (B, K-1, conv_dim) bf16;
    ssm_state (B, G, Hg, N, P) f32. Returns (y (B, D), conv_state',
    ssm_state'), new tensors as the reference's (the caller writes them into
    its cache). With ``tp``: ssm_state holds this rank's heads and
    conv_state its block of the channels (``cache_specs``, which splits
    conv_dim evenly over "model", not by heads: the window is gathered, the
    rank's channels read from it, and its block written back); y is the
    out-projection's partial sums."""
    B, D = x.shape
    Pd, N = cfg.ssm_headdim, cfg.ssm_state
    p, H, d_in = _local(p, cfg, tp)
    Hg = H // G
    z, xbc, dt_raw = _in_proj(p, x)
    # the conv over [state ; new], summed over the K taps in f32
    if tp is None:
        window = torch.cat([conv_state, xbc[:, None, :]], dim=1)      # (B, K, C)
        new_state = window[:, 1:]
    else:
        whole = torch.cat([tp.all_gather(xbc[:, :d_in], dim=-1), xbc[:, d_in:]], dim=-1)
        sharded = conv_state.shape[-1] != whole.shape[-1]
        if sharded:
            conv_state = tp.all_gather(conv_state, dim=-1)
        window = torch.cat([conv_state, whole[:, None, :]], dim=1)
        new_state = window[:, 1:]
        if sharded:
            new_state = new_state.chunk(tp.n_model, dim=-1)[tp.model_rank]
        window = window[..., _channels(cfg, tp, x.device)]
    wf, cw = window.float(), p["conv_w"].float()
    conv_out = wf[:, 0] * cw[0]
    for j in range(1, cw.shape[0]):
        conv_out = conv_out + wf[:, j] * cw[j]
    xbc = F.silu(conv_out).to(x.dtype)
    xin = xbc[:, :d_in]
    Bp = xbc[:, d_in:d_in + G * N].reshape(B, G, N).float()
    Cp = xbc[:, d_in + G * N:].reshape(B, G, N).float()
    dth = softplus(dt_raw.float() + p["dt_bias"].float()).reshape(B, G, Hg)
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B, G, Hg, Pd).float()
    decay = torch.exp(dth * A.reshape(1, G, Hg))                      # (B, G, Hg)
    upd = (dth[..., None] * Bp[:, :, None, :])[..., None] * xh[..., None, :]  # (B, G, Hg, N, P)
    ssm_state = decay[..., None, None] * ssm_state + upd
    y = (Cp[:, :, None, None, :] @ ssm_state)[..., 0, :]              # (B, G, Hg, P)
    y = y + xh * p["Dskip"].float().reshape(1, G, Hg, 1)
    y = y.reshape(B, d_in) * F.silu(z.float())
    y = _gated_norm(y, p["norm"], cfg.norm_eps, tp).to(x.dtype)
    return y @ p["wo"], new_state, ssm_state


def mamba2_param_shapes(cfg: ArchConfig) -> dict:
    """(shape, dtype) of one layer's parameters, the reference's names."""
    D, d_in, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    conv_dim = d_in + 2 * G * N
    K = cfg.conv_kernel
    f32, bf = torch.float32, dt(cfg)
    return {
        "wz": ((D, d_in), bf), "wx": ((D, d_in), bf),
        "wB": ((D, G * N), bf), "wC": ((D, G * N), bf),
        "wdt": ((D, H), bf), "dt_bias": ((H,), f32),
        "A_log": ((H,), f32), "Dskip": ((H,), f32),
        "conv_w": ((K, conv_dim), bf), "norm": ((d_in,), f32),
        "wo": ((d_in, D), bf),
    }
