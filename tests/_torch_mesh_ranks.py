"""Runs a case of the port's mesh layer on N gloo ranks (JAX-free, so the
card's machine runs it too).

The parent (``run_ranks``) writes the case's arguments to ``args.pt`` in a
fresh directory, starts N processes of this file (``python
_torch_mesh_ranks.py <case> <rank> <world> <dir>``), each with one thread,
which meet through a ``file://`` rendezvous in that directory (no port to
collide under pytest-xdist), and waits for them with a timeout. Each rank
returns a dict from its case, saved to ``rank<r>.pt``; ``run_ranks``
returns them in rank order. The ranks' process group times out with
``run_ranks``' ``timeout``: a rank that waits in a collective for a rank
that will never join fails then, as the parent does.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 420  # the reference's own multi-device test allows its subprocess as much


def run_ranks(case: str, world: int, workdir: Path, args: dict,
              timeout: float = TIMEOUT_S) -> list[dict]:
    """Run ``case`` on ``world`` gloo ranks with ``args``; each rank's result.
    A rank that fails ends the others (they would wait in a collective)."""
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(args, workdir / "args.pt")
    (workdir / "rendezvous").unlink(missing_ok=True)  # a stale file store hangs the ranks
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world), str(workdir),
                               str(timeout)], env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    bad = [(r, p.returncode, (workdir / f"rank{r}.log").read_text()[-3000:])
           for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, bad
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------------ the ranks
def _ctx(shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.sharding import MeshCtx

    return MeshCtx(init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names)))


def _whole(tree):
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def _layout(tree, specs) -> dict:
    """The DTensor leaves laid out otherwise than their specs say: name ->
    (placements, the spec's placements)."""
    from repro_torch.tree import named_leaves

    want = dict(named_leaves(specs))
    return {n: (x.placements, want[n].placements) for n, x in named_leaves(tree)
            if tuple(x.placements) != tuple(want[n].placements)}


def case_step(args: dict) -> dict:
    """One sharded train step from ``args["params"]`` (stored in the ZeRO
    layout of ``training_state_specs``, as the reference's test stores
    them), and the sharded prefill of ``args["prefill"]``; ``args["pure_dp"]``,
    where given, overrides the model's ``pure_dp``, and ``args["overrides"]``
    are replaced in the reduced config."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import (
        make_prefill_step,
        make_train_step,
        training_state_specs,
    )

    ctx = _ctx(args["shape"], args["names"])
    cfg = dataclasses.replace(get_arch(args["arch"]).reduced(), **args.get("overrides") or {})
    model = build_model(cfg, max_pos=args["max_pos"], device="cpu")
    if args.get("pure_dp") is not None:
        model.pure_dp = args["pure_dp"]
    pstore, ospecs = training_state_specs(model, ctx)
    params = reshard_state(args["params"], pstore)
    opt = reshard_state(adamw_init(args["params"]), ospecs)
    step = make_train_step(model, ctx, AdamWConfig(lr=args["lr"]))
    p1, o1, loss = step(params, opt, args["batch"])
    out = {"loss": float(loss), "params": _whole(p1), "opt": _whole(o1),
           "misplaced": {**_layout(p1, model.param_specs(ctx)), **_layout(o1["m"], ospecs["m"])}}
    out["logits"] = make_prefill_step(model, ctx)(args["params"], args["prefill"])
    return out


def case_tp(args: dict) -> dict:
    """Tensor and expert parallelism over "model", the reduced config
    (``args["overrides"]`` replaced in it, where given) run as a model that
    is not pure data-parallel (or as ``args["pure_dp"]`` says), once for
    each entry of ``args["runs"]`` (dtype -> its ``params``, ``batch``,
    ``prefill``, ``tokens`` or decode ``feeds``, the decode's starting
    ``cache`` where given, and whether to ``train``), on one mesh: with ``train``, one
    sharded train step from the parameters stored in the ZeRO layout and
    the gradients the step hands the optimizer (summed over "model" where
    the spec does not shard the leaf, averaged over the batch axes,
    gathered whole); then the sharded prefill and ``args["steps"]`` decode
    steps; the collectives each made, by kind. Returns dtype -> results."""
    ctx = _ctx(args["shape"], args["names"])
    return {dtype: _tp_run(ctx, {**args, **run}, dtype) for dtype, run in args["runs"].items()}


def case_tp_families(args: dict) -> dict:
    """``case_tp`` for each entry of ``args["families"]`` (name -> its
    ``arch``, ``overrides`` and ``runs``) on one mesh, in one launch: name ->
    dtype -> results."""
    ctx = _ctx(args["shape"], args["names"])
    return {name: {dtype: _tp_run(ctx, {**args, **family, **run}, dtype)
                   for dtype, run in family["runs"].items()}
            for name, family in args["families"].items()}


def _tp_run(ctx, args: dict, dtype: str) -> dict:
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = dataclasses.replace(get_arch(args["arch"]).reduced(), dtype=dtype,
                              **args.get("overrides", {}))
    model = build_model(cfg, max_pos=args["max_pos"], device="cpu")
    model.pure_dp = args.get("pure_dp", False)
    counts, out = {}, {}
    if args["train"]:
        out = _train_run(ctx, model, args["params"], args["batch"], args["lr"])
        counts["train"] = out.pop("counts")["step"]
    ctx.counts.clear()
    out["logits"] = make_prefill_step(model, ctx)(args["params"], args["prefill"])
    counts["prefill"] = dict(ctx.counts)
    ctx.counts.clear()
    out["decode"] = _decode(model, make_serve_step(model, ctx), args, ctx)
    counts["decode"] = dict(ctx.counts)
    out["counts"] = counts
    return out


def _train_run(ctx, model, params: dict, batch: dict, lr: float) -> dict:
    """One sharded train step of ``model`` from ``params`` stored in the
    ZeRO layout (``training_state_specs``): the loss, the new parameters
    and moments (whole), the leaves laid out otherwise than their specs,
    the gradients the step hands its optimizer (summed over "model" where
    the spec does not shard the leaf, averaged over the batch axes,
    gathered whole), and the collectives by kind: the step's, and those
    of its loss and gradients alone (``loss_and_grads``, the model's);
    ``MeshCtx.waits`` of the step."""
    from torch.distributed.tensor import DTensor

    import repro_torch.train.steps as steps
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step, training_state_specs
    from repro_torch.tree import tree_map

    pspecs = model.param_specs(ctx)
    pstore, ospecs = training_state_specs(model, ctx)
    placed = reshard_state(params, pstore)
    opt = reshard_state(adamw_init(params), ospecs)
    # the gradients the step hands its optimizer, as it hands them, and the
    # collectives of the loss and gradients alone
    update, grads_of, seen = steps.adamw_update_sharded, steps.loss_and_grads, {}

    def recording(params, grads, *rest):
        seen["grads"] = grads
        return update(params, grads, *rest)

    def counted(*a, **k):
        before = dict(ctx.counts)
        try:
            return grads_of(*a, **k)
        finally:
            seen["model"] = {n: c - before.get(n, 0) for n, c in ctx.counts.items()
                             if c != before.get(n, 0)}

    ctx.counts.clear()
    ctx.waits.clear()
    steps.adamw_update_sharded, steps.loss_and_grads = recording, counted
    try:
        p1, o1, loss = make_train_step(model, ctx, AdamWConfig(lr=lr))(placed, opt, batch)
    finally:
        steps.adamw_update_sharded, steps.loss_and_grads = update, grads_of
    out = {"loss": float(loss), "params": _whole(p1), "opt": _whole(o1),
           "misplaced": {**_layout(p1, pspecs), **_layout(o1["m"], ospecs["m"])},
           "counts": {"step": dict(ctx.counts), "model": seen["model"]},
           "waits": dict(ctx.waits)}
    grads = tree_map(lambda g: ctx.all_reduce(g.float(), ctx.batch_axes, "avg"), seen["grads"])
    mesh = ctx.device_mesh()
    out["grads"] = _whole(tree_map(lambda g, s: DTensor.from_local(g, mesh, s.placements,
                                                                   run_check=False),
                                   grads, pspecs))
    return out


def case_seq_train(args: dict) -> dict:
    """Sequence-sharded training: for each entry of ``args["runs"]`` (name
    -> its ``arch``, ``overrides`` and ``dtype`` replaced in the reduced
    config, ``params`` and the B = 1 train ``batch``), on one mesh whose
    batch axes B does not fill, a model that is not pure data-parallel:
    ``_train_run``'s one step. Name -> its results; ``seq_rank`` too, and
    where ``args["hops"]`` is given, ``_seq_hops``' results under
    "hops"."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model

    ctx = _ctx(args["shape"], args["names"])
    out = {}
    for name, run in args["runs"].items():
        cfg = dataclasses.replace(get_arch(run["arch"]).reduced(), **run.get("overrides", {}))
        model = build_model(cfg, max_pos=args["max_pos"], device="cpu")
        model.pure_dp = False
        out[name] = _train_run(ctx, model, run["params"], run["batch"], args["lr"])
    out["seq_rank"] = ctx.seq_rank
    if "hops" in args:
        out["hops"] = _seq_hops(ctx, args["hops"])
    return out


def _seq_hops(ctx, args: dict) -> dict:
    """Each hop over the sequence ranks alone, in the dtype of ``args``'
    tensors: this rank's block (along dim 1) of ``args["x"]`` through
    ``halo`` (``args["k"]`` rows), through ``gather_seq`` over the batch
    axes, and ``args["a"]``'s block through the relay pair, each into the
    scalar functions ``seq_hop_losses`` names; the gradient of each with
    respect to the block, and the collectives by kind."""
    r, n = ctx.seq_rank, ctx.n_batch
    out = {"seq_rank": r, "grads": {}}
    for hop in ("halo", "gather", "relay"):
        src = args["a" if hop == "relay" else "x"]
        L = src.shape[1] // n
        block = src[:, r * L:(r + 1) * L].clone().requires_grad_()
        ctx.counts.clear()
        loss = seq_hop_losses(hop, block, args, r, ctx)
        (g,) = torch.autograd.grad(loss, (block,))
        out["grads"][hop] = g
        out[f"counts_{hop}"] = dict(ctx.counts)
    return out


def seq_hop_losses(hop: str, block, args: dict, r: int, ctx=None):
    """Rank r's share of the scalar function of ``hop``'s output (with
    ``ctx`` on a rank of the mesh; ``ctx`` None on one device, where
    ``block`` is the whole tensor and the sum runs over every rank's
    share): ``halo``, sum of W_r * sin(the k rows before block r);
    ``gather``, sum of W_r * sin(the whole sequence); ``relay``, the state
    s entering block r (zeros for the first) is carried to the next as
    s * d_r + sum over block r's rows, and y_r = tanh(s) * block r; sum of
    W_r * y_r."""
    k, n = args["k"], args["n"]
    if ctx is None:
        L = block.shape[1] // n
        if hop == "relay":
            s, tot = torch.zeros_like(block[:, 0]), 0
            for q in range(n):
                part = block[:, q * L:(q + 1) * L]
                tot = tot + (args["W_relay"][q] * (torch.tanh(s)[:, None] * part)).sum()
                s = s * args["d"][q] + part.sum(dim=1)
            return tot
        if hop == "halo":
            return sum((args["W_halo"][q] * torch.sin(
                block[:, q * L - k:q * L] if q else torch.zeros_like(block[:, :k]))).sum()
                for q in range(n))
        return sum((args["W_gather"][q] * torch.sin(block)).sum() for q in range(n))
    if hop == "halo":
        return (args["W_halo"][r] * torch.sin(ctx.halo(block, k))).sum()
    if hop == "gather":
        return (args["W_gather"][r] * torch.sin(ctx.gather_seq(block, axes=ctx.batch_axes))).sum()
    s = ctx.relay_in(torch.zeros_like(block[:, 0]), after=block)
    y = ctx.relay_out(s * args["d"][r] + block.sum(dim=1), torch.tanh(s)[:, None] * block)
    return (args["W_relay"][r] * y).sum()


def case_seq_families(args: dict) -> dict:
    """Sequence sharding: for each entry of ``args["families"]`` (name ->
    its ``arch``, ``overrides``, ``params``, the B = 1 ``prefill`` batch,
    the decode's starting global ``cache``, its ``feeds`` and first
    ``start`` position), on one mesh whose batch axes B does not fill, a
    model that is not pure data-parallel (or as the entry's ``pure_dp``
    says; None: the model's own): the sharded prefill and the decode steps at ``start``, ``start +
    1``, ..., each with the collectives it made, by kind; for the MoE family
    the assignments each MoE layer of the prefill dropped, of those it
    routed (``RouteLog``). Where the entry has ``train`` (its
    ``overrides``, ``params`` and B = 1 train ``batch``), also
    ``_train_run``'s one step of that model. Also, where asked, the mesh's
    block order (``ctx.local``
    of ``args["positions"]`` positions under the spec ``(None,
    batch_axes)``, beside ``seq_rank``), the mixer alone on the rank's
    block (``args["mixer"]``: ``_seq_mixer``) and the error of a prefill
    whose rank blocks do not hold a whole number of SSM chunks
    (``args["ragged"]``: arch, overrides, params, batch)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    ctx = _ctx(args["shape"], args["names"])

    from _torch_moe_criteria import RouteLog

    def model_of(family: dict, overrides: dict | None = None):
        cfg = dataclasses.replace(get_arch(family["arch"]).reduced(),
                                  **(family["overrides"] if overrides is None else overrides))
        model = build_model(cfg, max_pos=args["max_pos"], device="cpu")
        pure_dp = family.get("pure_dp", False)  # None: the model's own
        if pure_dp is not None:
            model.pure_dp = pure_dp
        return model

    out = {}
    for name, family in args["families"].items():
        model = model_of(family)
        ctx.counts.clear()
        with RouteLog() as routes:
            logits = make_prefill_step(model, ctx)(family["params"], family["prefill"])
        counts = {"prefill": dict(ctx.counts)}
        drops = [(int(c["routed"].sum() - c["kept"].sum()), int(c["routed"].sum()))
                 for c in routes.calls]
        ctx.counts.clear()
        steps = _decode(model, make_serve_step(model, ctx),
                        {**family, "steps": len(family["feeds"]),
                         "cache_len": family["cache"]["k"].shape[2]
                         if "k" in family["cache"] else 0}, ctx, first=family["start"])
        counts["decode"] = {k: v / len(steps) for k, v in ctx.counts.items()}
        out[name] = {"logits": logits, "decode": steps, "counts": counts, "drops": drops}
        if "train" in family:
            train = family["train"]
            out[name]["train"] = _train_run(ctx, model_of(family, train["overrides"]),
                                            train["params"], train["batch"], args["lr"])
    out["seq_rank"] = ctx.seq_rank
    if "positions" in args:
        S = args["positions"]
        out["block"] = ctx.local(torch.arange(S)[None], ctx.ns(None, ctx.batch_axes))
    if "mixer" in args:
        out["mixer"] = _seq_mixer(ctx, args["mixer"])
    if "ragged" in args:
        ragged = args["ragged"]
        try:
            make_prefill_step(model_of(ragged), ctx)(ragged["params"], ragged["prefill"])
            out["ragged"] = None
        except ValueError as e:
            out["ragged"] = str(e)
    return out


def _seq_mixer(ctx, args: dict) -> dict:
    """The reduced mamba2's mixer on this rank's block of ``args["x"]``
    (sequence-sharded over the batch axes) beside the whole sequence's
    mixer's rows of the block; the (shape, dtype) of every tensor the
    relay sent; the halo of the conv's input beside the rows before the
    block (zeros on the first rank)."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.models import ssd

    cfg = get_arch("mamba2_2_7b").reduced()
    p, x = args["p"], args["x"]
    L = x.shape[1] // ctx.n_batch
    first = ctx.seq_rank * L
    sent, send = [], dist.send

    def recording(t, *a, **k):
        sent.append((tuple(t.shape), t.dtype))
        return send(t, *a, **k)

    dist.send = recording
    try:
        block = ssd.mamba2_mixer(p, x[:, first:first + L].contiguous(), cfg, sp=ctx)
    finally:
        dist.send = send
    xbc = ssd._in_proj(p, x)[1]
    K = p["conv_w"].shape[0]
    want = xbc[:, first - K + 1:first] if first else torch.zeros_like(xbc[:, :K - 1])
    return {"block": block, "whole": ssd.mamba2_mixer(p, x, cfg)[:, first:first + L],
            "sent": sent, "halo": ctx.halo(xbc[:, first:first + L].contiguous(), K - 1),
            "halo_want": want}


def case_seq_shared_card(args: dict) -> dict:
    """On the card: ``make_shared_card_mesh(args["shape"])``, whose batch
    axes B = 1 does not fill, and each of ``args["archs"]`` at full width
    and ``args["layers"]`` layers, not pure data-parallel, its weights drawn
    on the card from ``args["seed"]``: the sequence-sharded prefill of
    ``args["tokens"]`` (1, S), its logits on the host, the flash kernel's
    launches and the collectives by kind."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.mesh import make_shared_card_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import MeshCtx
    from repro_torch.train.steps import make_prefill_step

    torch.cuda.set_device(0)
    ctx = MeshCtx(make_shared_card_mesh(args["shape"]))
    tokens, out = args["tokens"].cuda(), {}
    for arch in args["archs"]:
        cfg = dataclasses.replace(get_arch(arch), n_layers=args["layers"])
        model = build_model(cfg, max_pos=tokens.shape[1])
        model.pure_dp = False
        params = model.init_params(torch.Generator(device="cuda").manual_seed(args["seed"]))
        fa.launches = 0
        ctx.counts.clear()
        logits = make_prefill_step(model, ctx)(params, {"tokens": tokens})
        out[arch] = {"logits": logits.cpu(), "launches": fa.launches, "counts": dict(ctx.counts)}
    return out


def case_shared_card(args: dict) -> dict:
    """On the card: ``make_shared_card_mesh`` over this gloo group, which
    ``MeshCtx`` takes, and a CUDA mesh over gloo built any other way, which
    it refuses (NCCL's); the reduced config, not pure data-parallel, served
    on the shared-card mesh: the sharded prefill of ``args["prefill"]`` and
    ``args["steps"]`` decode steps, their logits on the host."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_shared_card_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import MeshCtx
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_map

    torch.cuda.set_device(0)
    ctx = MeshCtx(make_shared_card_mesh(args["shape"]))
    refused = None
    try:
        MeshCtx(init_device_mesh("cuda", args["shape"], mesh_dim_names=args["names"]))
    except ValueError as e:
        refused = str(e)
    model = build_model(get_arch(args["arch"]).reduced(), max_pos=args["max_pos"])
    model.pure_dp = False
    params = tree_map(lambda t: t.cuda(), args["params"])
    logits = make_prefill_step(model, ctx)(params, {k: v.cuda() for k, v in args["prefill"].items()})
    args = {**args, "tokens": args["tokens"].cuda()}
    return {"refused": refused, "logits": logits.cpu(), "counts": dict(ctx.counts),
            "decode": [x.cpu() for x in _decode(model, make_serve_step(model, ctx), args, ctx)]}


def case_adamw(args: dict) -> dict:
    """``adamw_update_sharded`` with the same whole gradients on every rank,
    three steps, and ``adamw_update``'s on this rank alone."""
    from repro_torch.train.optimizer import (
        AdamWConfig,
        adamw_init,
        adamw_specs,
        adamw_update,
        adamw_update_sharded,
    )
    from repro_torch.tree import tree_map

    ctx = _ctx(args["shape"], args["names"])
    template = tree_map(lambda t: (tuple(t.shape), t.dtype), args["params"])
    pspecs = tree_map(lambda _: ctx.replicated(), template)
    zspecs = adamw_specs(pspecs, template, ctx)["m"]
    cfg = AdamWConfig(**args["cfg"])
    p, st = args["params"], adamw_init(args["params"])
    ps, sts = p, st
    for g in args["grads"]:
        p, st = adamw_update(p, g, st, cfg)
        ps, sts = adamw_update_sharded(ps, g, sts, cfg, ctx, pspecs, zspecs)
    return {"plain": (p, st), "sharded": (_whole(ps), _whole(sts)),
            "local_m": tree_map(lambda x: x.to_local(), sts["m"]),
            "zspecs": tree_map(lambda s: s.spec, zspecs),
            "coord": dict(zip(ctx.axis_names, ctx.device_mesh().get_coordinate()))}


def case_elastic(args: dict) -> dict:
    """A train step on the old mesh, ``elastic_resize`` through rank 0's
    store, the restored state placed on the new mesh, a further step there."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.checkpoint import ECCheckpointStore
    from repro_torch.train.elastic import elastic_resize, reshard_state
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step, training_state_specs
    from repro_torch.tree import tree_map

    model = build_model(get_arch(args["arch"]).reduced(), max_pos=args["max_pos"], device="cpu")
    old, new = _ctx(*args["old"]), _ctx(*args["new"])
    cfg = AdamWConfig(lr=args["lr"])
    pstore, ospecs = training_state_specs(model, old)
    params = reshard_state(args["params"], pstore)
    opt = reshard_state(adamw_init(args["params"]), ospecs)
    params, opt, loss = make_train_step(model, old, cfg)(params, opt, args["batch"])
    saved = _whole({"params": params, "opt": opt})
    store = None
    if torch.distributed.get_rank() == 0:
        store = ECCheckpointStore(n_hosts=args["hosts"], parity=args["parity"], seed=0,
                                  device="cpu")
    step, state, moved = elastic_resize(store, {"params": params, "opt": opt}, 1,
                                        new_hosts=args["new_hosts"], new_parity=args["new_parity"])
    pstore2, ospecs2 = training_state_specs(model, new)
    placed = reshard_state(state, {"params": model.param_specs(new), "opt": ospecs2})
    step_new = make_train_step(model, new, cfg)
    p2, o2, loss2 = step_new(placed["params"], placed["opt"], args["batch2"])
    # the same step from the state before the save, placed without the store
    direct = reshard_state(saved, {"params": model.param_specs(new), "opt": ospecs2})
    p3, o3, loss3 = step_new(direct["params"], direct["opt"], args["batch2"])
    return {"saved": saved, "step": step, "moved": moved,
            "local": tree_map(lambda x: x.to_local().clone(), placed),
            "specs": {"params": tree_map(lambda s: s.spec, model.param_specs(new)),
                      "opt": tree_map(lambda s: s.spec, ospecs2)},
            "index": new.index(new.batch_axes), "loss": float(loss), "loss2": float(loss2),
            "after": _whole({"params": p2, "opt": o2}), "loss3": float(loss3),
            "after_direct": _whole({"params": p3, "opt": o3})}


def case_host(args: dict) -> dict:
    """On one rank: ``make_host_mesh("cpu")``, the production meshes'
    refusal of a group of 1, and a sharded train step, prefill and decode
    on the host mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import MeshCtx
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step

    errors = []
    for kw in ({}, {"multi_pod": True}):
        try:
            make_production_mesh(device="cpu", **kw)
        except ValueError as e:
            errors.append(str(e))
    ctx = MeshCtx(make_host_mesh("cpu"))
    model = build_model(get_arch(args["arch"]).reduced(), max_pos=args["max_pos"], device="cpu")
    p1, o1, loss = make_train_step(model, ctx, AdamWConfig(lr=args["lr"]))(
        args["params"], adamw_init(args["params"]), args["batch"])
    return {"errors": errors, "shape": ctx.shape, "loss": float(loss), "params": _whole(p1),
            "opt": _whole(o1),
            "logits": make_prefill_step(model, ctx)(args["params"], args["prefill"]),
            "decode": _decode(model, make_serve_step(model, ctx), args, ctx)}


def case_serve(args: dict) -> dict:
    """Decode steps of the batch's tokens with the cache sharded over the
    batch axes (``cache_specs``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_serve_step

    ctx = _ctx(args["shape"], args["names"])
    model = build_model(get_arch(args["arch"]).reduced(), max_pos=args["max_pos"], device="cpu")
    return {"decode": _decode(model, make_serve_step(model, ctx), args, ctx)}


def _decode(model, serve_step, args: dict, ctx, first: int = 0) -> list:
    """The logits of ``args["steps"]`` decode steps from ``args["cache"]``
    (the global cache, where given) or a zero cache, step i at position
    ``first + i`` fed ``args["feeds"][i]`` (where given) or the tokens
    ``args["tokens"][:, i]``."""
    from repro_torch.train.elastic import reshard_state

    feeds = args.get("feeds") or [{"token": args["tokens"][:, i]} for i in range(args["steps"])]
    B = next(iter(feeds[0].values())).shape[0]
    start = args.get("cache") or model.init_cache(B, args["cache_len"])
    cache = reshard_state({k: v.clone() for k, v in start.items()},
                          model.cache_specs(B, args["cache_len"], ctx))
    out = []
    for i in range(args["steps"]):
        logits, cache = serve_step(args["params"], cache, {**feeds[i], "cur_len": first + i})
        out.append(logits)
    return out


def case_dryrun_counts(args: dict) -> dict:
    """The dry run's counts of ``args["archs"]``' train step and prefill
    (``_torch_dryrun.trace_mesh``) on real CPU tensors over these gloo
    ranks: what the fake trace of the same steps must count."""
    from _torch_dryrun import KINDS, MESH, B, trace_mesh

    return trace_mesh(args["archs"], args.get("kinds", KINDS), fake=False,
                      mesh_of=args.get("mesh", MESH), batch=args.get("B", B))


def main() -> int:
    import torch.distributed as dist

    case, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    timeout = datetime.timedelta(seconds=float(sys.argv[5]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}", rank=rank,
                            world_size=world, timeout=timeout)
    try:
        out = globals()[f"case_{case}"](torch.load(workdir / "args.pt", weights_only=False))
        torch.save(out, workdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
