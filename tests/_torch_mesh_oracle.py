"""The reference's sharded train step and prefill, as oracles of the port's
mesh layer.

``reference_run`` starts one subprocess with ``--xla_force_host_platform_
device_count`` fake CPU devices, on a mesh made with ``axis_types=(AxisType.
Auto,) * n`` (jax 0.9's default mesh has Explicit axes, on which the
reference's ``MeshCtx.constrain`` raises: ROADMAP C), and runs there what
``tests/test_dryrun_multidevice.py`` runs: ``make_train_step(model, ctx)``
jitted with the shardings of ``training_state_specs`` and
``batch_shardings``, from the parameters and batch it is given; and, where
asked, ``make_prefill_step(model, ctx)`` with the model's attention swapped
for the reference's ``flash_attention_ref`` at the layer's window (the
port's prefill attends with the flash kernel: ``tests/test_torch_models.py``),
compiled with every bf16 rounding kept. ``reference_seq_run`` runs the
reference's ``make_prefill_step`` and ``make_serve_step`` at B = 1, which
shards the sequence over the batch axes (``token_spec``, ``cache_specs``),
as ``launch/dryrun.py`` jits them, for several archs and meshes in one
subprocess; ``reference_seq_train_run`` its ``make_train_step`` at B = 1,
which shards the sequence likewise, the same way.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from repro_torch.tree import named_leaves

ROOT = Path(__file__).resolve().parents[1]
B, S, LR = 4, 256, 3e-4  # S > 128: the chunked cross-entropy runs
LOGIT_ATOL = 4 * 2.0**-6  # tests/test_torch_models.py's serving criterion

_SCRIPT = textwrap.dedent(
    """
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    import repro.models.layers as jax_layers
    import repro.models.lm as jax_lm
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.kernels.flash_attention.ref import flash_attention_ref
    from repro.models.registry import build_model
    from repro.models.sharding import MeshCtx
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.steps import (batch_shardings, make_prefill_step, make_train_step,
                                   training_state_specs)

    # the expert-parallel moe_layer's pmean over every axis fails jax 0.9's
    # varying-axes check on a mesh whose "model" is 1 (its tokens do not vary
    # over "model"); unchecked, as the reference's own optimizer runs its
    # shard_map, the pmean over a 1-long axis is the identity
    _shard_map = jax_layers.shard_map_compat
    jax_layers.shard_map_compat = lambda f, **kw: _shard_map(f, check_vma=False, **kw)
    src = np.load(sys.argv[1])
    mesh = jax.make_mesh({shape}, {names}, axis_types=(AxisType.Auto,) * {ndim})
    ctx = MeshCtx(mesh)
    cfg = dataclasses.replace(get_arch("{arch}").reduced(), **{overrides})
    model = build_model(cfg, max_pos={max_pos})
    if {pure_dp} is not None:
        model.pure_dp = {pure_dp}
    tmpl = model.param_shapes()
    flat, tree = jax.tree_util.tree_flatten_with_path(tmpl)
    name = lambda path: ".".join(k.key for k in path)
    params = jax.tree.unflatten(tree, [jnp.asarray(src["p:" + name(p)], sd.dtype)
                                       for p, sd in flat])
    batch = {{k[2:]: src[k] for k in src.files if k.startswith("b:")}}
    shape = ShapeConfig("t", batch["labels"].shape[1], batch["labels"].shape[0], "train")
    batch = {{k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else v.dtype)
              for k, v in batch.items()}}
    pstore, ospecs = training_state_specs(model, ctx)
    jitted = jax.jit(make_train_step(model, ctx, AdamWConfig(lr={lr})),
                     in_shardings=(pstore, ospecs, batch_shardings(cfg, shape, ctx)),
                     out_shardings=(pstore, ospecs, ctx.replicated()))
    p1, o1, loss = jitted(params, adamw_init(params), batch)
    out = {{"loss": np.asarray(loss)}}
    for p, leaf in jax.tree_util.tree_flatten_with_path(p1)[0]:
        out["p:" + name(p)] = np.asarray(leaf, np.float32)
    pre = {{k[2:]: src[k] for k in src.files if k.startswith("f:")}}
    if pre:
        sw = cfg.sliding_window
        def attention(q, k, v, *, q_pos, k_pos, causal=True, window=None, ctx=None, **_):
            G = q.shape[2] // k.shape[2]
            qh, kh, vh = (x.transpose(0, 2, 1, 3) for x in
                          (q, jnp.repeat(k, G, axis=2), jnp.repeat(v, G, axis=2)))
            ref = lambda w: flash_attention_ref(qh, kh, vh, causal=causal,
                                                window=w).transpose(0, 2, 1, 3)
            # the window is traced (the stack is a scan): it is S + 1 (no
            # limit under the causal mask) or the arch's sliding window
            return ref(0) if not sw else jax.lax.cond(window == sw, lambda: ref(sw),
                                                      lambda: ref(0))
        jax_lm.gqa_attention = attention
        pre = {{k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else v.dtype)
                for k, v in pre.items()}}
        fn = jax.jit(make_prefill_step(model, ctx))
        out["logits"] = np.asarray(fn.lower(params, pre).compile(
            compiler_options={{"xla_allow_excess_precision": False}})(params, pre))
    np.savez(sys.argv[2], **out)
    """
)


_SEQ_SCRIPT = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    import repro.models.layers as jax_layers
    import repro.models.lm as jax_lm
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.kernels.flash_attention.ref import flash_attention_ref
    from repro.models.registry import build_model
    from repro.models.sharding import MeshCtx
    from repro.train.steps import batch_shardings, make_prefill_step, make_serve_step

    # the expert-parallel moe_layer's pmean over every axis fails jax 0.9's
    # varying-axes check on a mesh whose "model" is 1 (its tokens do not vary
    # over "model"); unchecked, as the reference's own optimizer runs its
    # shard_map, the pmean over a 1-long axis is the identity
    _shard_map = jax_layers.shard_map_compat
    jax_layers.shard_map_compat = lambda f, **kw: _shard_map(f, check_vma=False, **kw)
    src, meta = np.load(sys.argv[1]), json.loads(open(sys.argv[3]).read())
    exact = {{"xla_allow_excess_precision": False}}
    gqa = jax_lm.gqa_attention
    out = {{}}
    for label, shape, names, arch, m in [(label, shape, names, arch, m)
                                         for label, (shape, names) in {meshes}.items()
                                         for arch, m in meta.items()]:
        n = int(np.prod(shape))
        ctx = MeshCtx(jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                                    devices=jax.devices()[:n]))
        cfg = dataclasses.replace(get_arch(m["arch"]).reduced(), **m["overrides"])
        model = build_model(cfg, max_pos=m["max_pos"])
        if m["pure_dp"] is not None:
            model.pure_dp = m["pure_dp"]
        flat, tree = jax.tree_util.tree_flatten_with_path(model.param_shapes())
        name = lambda path: ".".join(k.key for k in path)
        params = jax.tree.unflatten(tree, [jnp.asarray(src[f"{{arch}}/p:" + name(p)], sd.dtype)
                                           for p, sd in flat])
        pspecs = model.param_specs(ctx, serve=True)
        head = f"{{arch}}/f:"
        batch = {{k[len(head):]: jnp.asarray(src[k], jnp.bfloat16 if src[k].dtype == np.float32
                                            else src[k].dtype)
                  for k in src.files if k.startswith(head)}}
        B, S = batch["tokens" if "tokens" in batch else "embeds"].shape[:2]
        bsh = batch_shardings(cfg, ShapeConfig("t", S, B, "prefill"), model=model, ctx=ctx)
        sw = cfg.sliding_window
        def attention(q, k, v, *, q_pos, k_pos, causal=True, window=None, ctx=None, **_):
            G = q.shape[2] // k.shape[2]
            qh, kh, vh = (x.transpose(0, 2, 1, 3) for x in
                          (q, jnp.repeat(k, G, axis=2), jnp.repeat(v, G, axis=2)))
            ref = lambda w: flash_attention_ref(qh, kh, vh, causal=causal,
                                                window=w).transpose(0, 2, 1, 3)
            return ref(0) if not sw else jax.lax.cond(window == sw, lambda: ref(sw),
                                                      lambda: ref(0))
        # the prefill attends through the flash oracle (the port's prefill: the flash kernel)
        jax_lm.gqa_attention = attention
        fn = jax.jit(make_prefill_step(model, ctx),
                     in_shardings=(pspecs, {{k: bsh[k] for k in batch}}),
                     out_shardings=ctx.replicated())
        out[f"{{label}}/{{arch}}/prefill"] = np.asarray(fn.lower(params, batch).compile(exact)(
            params, batch))
        jax_lm.gqa_attention = gqa
        cache = {{k[len(arch) + 3:]: jnp.asarray(src[k], jnp.float32 if k.endswith(":ssm") else
                                                  jnp.bfloat16)
                  for k in src.files if k.startswith(f"{{arch}}/c:")}}
        L = cache["k"].shape[2] if "k" in cache else 0
        dsh = batch_shardings(cfg, ShapeConfig("t", L, B, "decode"), model=model, ctx=ctx)
        cspecs = model.cache_specs(B, L, ctx)
        step = jax.jit(make_serve_step(model, ctx), in_shardings=(pspecs, cspecs, dsh),
                       out_shardings=(ctx.replicated(), cspecs))
        feeds = src[f"{{arch}}/feeds"]
        key, cast = ("embed", jnp.bfloat16) if feeds.dtype == np.float32 else ("token", feeds.dtype)
        first = {{key: jnp.asarray(feeds[0], cast), "cur_len": jnp.int32(m["start"])}}
        compiled = step.lower(params, cache, first).compile(exact)
        for i in range(feeds.shape[0]):
            logits, cache = compiled(params, cache, {{key: jnp.asarray(feeds[i], cast),
                                                     "cur_len": jnp.int32(m["start"] + i)}})
            out[f"{{label}}/{{arch}}/decode{{i}}"] = np.asarray(logits)
    np.savez(sys.argv[2], **out)
    """
)


_SEQ_TRAIN_SCRIPT = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.models.registry import build_model
    from repro.models.sharding import MeshCtx
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.steps import batch_shardings, make_train_step, training_state_specs
    import repro.models.layers as jax_layers

    # the expert-parallel moe_layer's pmean over every axis fails jax 0.9's
    # varying-axes check on a mesh whose "model" is 1 (its tokens do not vary
    # over "model"); unchecked, as the reference's own optimizer runs its
    # shard_map, the pmean over a 1-long axis is the identity
    _shard_map = jax_layers.shard_map_compat
    jax_layers.shard_map_compat = lambda f, **kw: _shard_map(f, check_vma=False, **kw)
    src, meta = np.load(sys.argv[1]), json.loads(open(sys.argv[3]).read())
    exact = {{"xla_allow_excess_precision": False}}
    name = lambda path: ".".join(k.key for k in path)
    out = {{}}
    for label, (shape, names, keys) in {meshes}.items():
        n = int(np.prod(shape))
        ctx = MeshCtx(jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                                    devices=jax.devices()[:n]))
        for key in keys:
            m = meta[key]
            cfg = dataclasses.replace(get_arch(m["arch"]).reduced(), **m["overrides"])
            model = build_model(cfg, max_pos=m["max_pos"])
            if m["pure_dp"] is not None:
                model.pure_dp = m["pure_dp"]
            flat, tree = jax.tree_util.tree_flatten_with_path(model.param_shapes())
            params = jax.tree.unflatten(tree, [jnp.asarray(src[f"{{key}}/p:" + name(p)], sd.dtype)
                                               for p, sd in flat])
            head = f"{{key}}/b:"
            batch = {{k[len(head):]: jnp.asarray(src[k], jnp.bfloat16 if src[k].dtype == np.float32
                                                else src[k].dtype)
                      for k in src.files if k.startswith(head)}}
            B, S = batch["labels"].shape
            bsh = batch_shardings(cfg, ShapeConfig("t", S, B, "train"), model=model, ctx=ctx)
            pstore, ospecs = training_state_specs(model, ctx)
            step = jax.jit(make_train_step(model, ctx, AdamWConfig(lr={lr})),
                           in_shardings=(pstore, ospecs, {{k: bsh[k] for k in batch}}),
                           out_shardings=(pstore, ospecs, ctx.replicated()))
            opt = adamw_init(params)
            p1, o1, loss = step.lower(params, opt, batch).compile(exact)(params, opt, batch)
            out[f"{{label}}/{{key}}/loss"] = np.asarray(loss)
            for part, tree_ in (("p", p1), ("m", o1["m"]), ("v", o1["v"])):
                for p, leaf in jax.tree_util.tree_flatten_with_path(tree_)[0]:
                    out[f"{{label}}/{{key}}/{{part}}:" + name(p)] = np.asarray(leaf, np.float32)
    np.savez(sys.argv[2], **out)
    """
)


class ReferenceFailed(AssertionError):
    """The reference's run exited with an error; the message is the end of
    its standard error."""


def reference_run(arch: str, shape: tuple[int, ...], names: tuple[str, ...], params: dict,
                  batch: dict, workdir: Path, *, max_pos: int, lr: float,
                  prefill: dict | None = None, pure_dp: bool | None = None,
                  overrides: dict | None = None, timeout: float = 420) -> dict:
    """The reference's sharded step (and prefill) on an Auto mesh of
    ``shape``/``names``: ``{"loss", "params": {dotted name: f32 array},
    "logits"}``. ``params`` (dotted name -> numpy, bf16 as f32) and
    ``batch``/``prefill`` (numpy; float inputs as f32 of bf16 values) are
    what both packages are fed. ``pure_dp`` overrides the model's
    ``pure_dp`` (False: the reduced configs run tensor and expert parallel
    over "model", as the catalog's models do); ``overrides`` are replaced
    in the reduced config."""
    workdir.mkdir(parents=True, exist_ok=True)
    src, dst = workdir / "in.npz", workdir / "out.npz"
    arrays = {**{f"p:{k}": np.asarray(v, np.float32) for k, v in params.items()},
              **{f"b:{k}": v for k, v in batch.items()},
              **{f"f:{k}": v for k, v in (prefill or {}).items()}}
    np.savez(src, **arrays)
    script = _SCRIPT.format(n=int(np.prod(shape)), shape=tuple(shape), names=tuple(names),
                            ndim=len(shape), arch=arch, max_pos=max_pos, lr=lr, pure_dp=pure_dp,
                            overrides=overrides or {})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script, str(src), str(dst)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise ReferenceFailed(out.stderr[-3000:])
    got = np.load(dst)
    return {"loss": float(got["loss"]),
            "params": {k[2:]: got[k] for k in got.files if k.startswith("p:")},
            "logits": got["logits"] if "logits" in got.files else None}


def reference_seq_run(meshes: dict, archs: dict, workdir: Path, timeout: float = 420) -> dict:
    """The reference's sequence-sharded serving on Auto meshes (``meshes``:
    label -> (shape, names), on the first devices of as many fake ones as
    the largest takes; B = 1 does not fill their batch axes), for each
    entry of ``archs`` (name -> ``arch``, ``overrides``, ``max_pos``, numpy
    ``params`` (dotted name -> array, bf16 as f32), ``tokens`` (1, S) or
    the family's whole ``prefill`` batch (``tokens``; ``embeds`` and
    ``positions``; ``audio_embeds`` and ``tokens``; floats as f32 of bf16
    values), ``cache`` (the decode's starting cache, bf16 as f32, whisper's
    ``xk``/``xv`` of any frame count), ``feeds`` (steps, 1) tokens or
    (steps, 1, D) f32 embeddings, ``start`` and, where given, ``pure_dp``
    (None: the model's own; False where not given)),
    in one subprocess: its ``make_prefill_step`` (the attention swapped for
    its flash oracle) and ``make_serve_step`` at ``start``, ``start + 1``,
    ..., jitted on the shardings ``launch/dryrun.py`` gives them
    (``param_specs(ctx, serve=True)``, ``batch_shardings``,
    ``cache_specs``), models not pure data-parallel (or as ``pure_dp``
    says), compiled with every bf16 rounding kept: label -> name ->
    {"prefill", "decode": [logits]}."""
    import json

    workdir.mkdir(parents=True, exist_ok=True)
    src, dst, meta = workdir / "in.npz", workdir / "out.npz", workdir / "meta.json"
    arrays = {}
    for a, m in archs.items():
        arrays.update({f"{a}/p:{k}": np.asarray(v, np.float32) for k, v in m["params"].items()})
        arrays.update({f"{a}/c:{k}": np.asarray(v, np.float32) for k, v in m["cache"].items()})
        arrays.update({f"{a}/f:{k}": v for k, v in m.get("prefill", {"tokens": m.get("tokens")}
                                                       ).items()})
        arrays[f"{a}/feeds"] = m["feeds"]
    np.savez(src, **arrays)
    meta.write_text(json.dumps({a: {**{k: m[k] for k in ("arch", "overrides", "max_pos", "start")},
                                    "pure_dp": m.get("pure_dp", False)} for a, m in archs.items()}))
    script = _SEQ_SCRIPT.format(n=max(int(np.prod(sh)) for sh, _ in meshes.values()),
                                meshes={k: (tuple(sh), tuple(nm)) for k, (sh, nm) in meshes.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script, str(src), str(dst), str(meta)], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise ReferenceFailed(out.stderr[-3000:])
    got = np.load(dst)
    return {k: {a: {"prefill": got[f"{k}/{a}/prefill"],
                    "decode": [got[f"{k}/{a}/decode{i}"] for i in range(len(m["feeds"]))]}
                for a, m in archs.items()} for k in meshes}


def reference_seq_train_run(meshes: dict, archs: dict, workdir: Path, *, lr: float,
                            timeout: float = 420) -> dict:
    """The reference's sequence-sharded train step on Auto meshes
    (``meshes``: label -> (shape, names, the keys of ``archs`` to run
    there), on the first devices of as many fake ones as the largest
    takes; B = 1 does not fill their batch axes, so ``batch_shardings``
    shards the sequence), for entries of ``archs`` (key -> ``arch``,
    ``overrides``, ``max_pos``, numpy ``params`` (dotted name -> array,
    bf16 as f32), the B = 1 ``batch`` (tokens, or the family's inputs, and
    labels; floats as f32 of bf16 values) and, where given, ``pure_dp``
    (None: the model's own; False where not given)),
    in one subprocess: ``make_train_step`` jitted on
    ``training_state_specs`` and ``batch_shardings``, models not pure
    data-parallel (or as ``pure_dp`` says), compiled with every
    bf16 rounding kept (the default compile skips some, and moves reduced
    qwen2-0.5b's gradients ~9 %: ``_torch_train_pair``): label -> key ->
    {"loss", "params", "m", "v"} (dotted name -> f32 array)."""
    import json

    workdir.mkdir(parents=True, exist_ok=True)
    src, dst, meta = workdir / "in.npz", workdir / "out.npz", workdir / "meta.json"
    arrays = {}
    for key, m in archs.items():
        arrays.update({f"{key}/p:{k}": np.asarray(v, np.float32) for k, v in m["params"].items()})
        arrays.update({f"{key}/b:{k}": np.asarray(v) for k, v in m["batch"].items()})
    np.savez(src, **arrays)
    meta.write_text(json.dumps({k: {**{f: m[f] for f in ("arch", "overrides", "max_pos")},
                                    "pure_dp": m.get("pure_dp", False)} for k, m in archs.items()}))
    script = _SEQ_TRAIN_SCRIPT.format(
        n=max(int(np.prod(sh)) for sh, _, _ in meshes.values()), lr=lr,
        meshes={k: (tuple(sh), tuple(nm), list(keys)) for k, (sh, nm, keys) in meshes.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script, str(src), str(dst), str(meta)], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise ReferenceFailed(out.stderr[-3000:])
    got = np.load(dst)

    def part(label: str, key: str, prefix: str) -> dict:
        head = f"{label}/{key}/{prefix}:"
        return {k[len(head):]: got[k] for k in got.files if k.startswith(head)}

    return {label: {key: {"loss": float(got[f"{label}/{key}/loss"]),
                          **{n: part(label, key, p) for n, p in
                             (("params", "p"), ("m", "m"), ("v", "v"))}}
                    for key in keys} for label, (_, _, keys) in meshes.items()}


def as_f32(arrays: dict) -> dict:
    """``arrays`` with each bf16 array as f32 (``reference_run``'s inputs)."""
    return {k: v.astype(np.float32) if v.dtype.name == "bfloat16" else v
            for k, v in arrays.items()}


def reference_inputs(arch: str, overrides: dict, *, B: int, S: int,
                     index_positions: bool = False) -> tuple:
    """(the reduced config with ``overrides``, the reference's parameters
    (``init_params(PRNGKey(0))``; whisper's 1-D leaves drawn, as in
    ``tests/_torch_train_pair.py``), [its ``make_inputs`` B x S train batch
    (seed 1), its prefill batch (seed 2)]), all numpy. ``index_positions``
    replaces the VLM's M-RoPE positions by the index on all three streams."""
    import dataclasses

    import jax

    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.models.lm import LM
    from repro.models.registry import make_inputs

    from _torch_encdec import norm_draw

    cfg = dataclasses.replace(get_arch(arch).reduced(), **overrides)
    jp = jax.tree.map(np.asarray, LM(cfg, max_pos=S).init_params(jax.random.PRNGKey(0)))
    if cfg.family == "encdec":
        rng = np.random.default_rng(1)
        jp = {k: ({n: v for n, v in sub.items()} if isinstance(sub, dict) else
                  norm_draw(rng, sub.shape, k.endswith("ln")).astype(sub.dtype)
                  if sub.ndim == 1 else sub) for k, sub in jp.items()}
    inputs = [{k: np.asarray(v) for k, v in make_inputs(
        cfg, ShapeConfig("t", S, B, kind), seed=seed).items() if kind == "train" or
               k != "labels"} for kind, seed in (("train", 1), ("prefill", 2))]
    if index_positions:
        for d in inputs:
            d["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                             d["positions"].shape).copy()
    return cfg, jp, inputs


class OracleCase:
    """One arch on one mesh, both packages from the reference's parameters
    (``init_params(PRNGKey(0))``; whisper's 1-D leaves drawn, as in
    ``tests/_torch_train_pair.py``) and its ``make_inputs`` (B x S train
    batch, seed 1; prefill batch, seed 2): the reference's sharded step and
    prefill (``reference_run``) and the port's on gloo ranks
    (``_torch_mesh_ranks``, case ``step``); ``pure_dp`` overrides both
    models' ``pure_dp``, and ``overrides`` are replaced in both reduced
    configs. ``index_positions`` replaces the VLM's M-RoPE positions by the
    index on all three streams (the reference's training masks by their
    values, the port's prefill by index: ROADMAP C)."""

    def __init__(self, arch: str, shape: tuple[int, ...], names: tuple[str, ...], workdir: Path,
                 *, B: int, S: int, lr: float, pure_dp: bool | None = None,
                 overrides: dict | None = None, index_positions: bool = False):
        from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

        from _torch_mesh_ranks import run_ranks

        overrides = overrides or {}
        cfg, jp, inputs = reference_inputs(arch, overrides, B=B, S=S,
                                           index_positions=index_positions)
        self.cfg = cfg
        self.ref = reference_run(arch, shape, names, dict(named_leaves(jp)), as_f32(inputs[0]),
                                 workdir / "reference", max_pos=S, lr=lr,
                                 prefill=as_f32(inputs[1]),
                                 pure_dp=pure_dp, overrides=overrides)
        torch_in = [{k: tensor_from_numpy(v) for k, v in d.items()} for d in inputs]
        self.port = run_ranks("step", int(np.prod(shape)), workdir / "port", dict(
            arch=arch, shape=shape, names=names, max_pos=S, params=params_from_numpy(jp),
            batch=torch_in[0], prefill=torch_in[1], lr=lr, pure_dp=pure_dp, overrides=overrides))


def assert_step_meets_reference_bound(case: OracleCase) -> None:
    """The reference's own bound (``tests/test_dryrun_multidevice.py``):
    loss within 0.05, every parameter ``allclose(rtol=3e-2, atol=3e-2)``."""
    got, want = case.port[0], case.ref
    assert abs(got["loss"] - want["loss"]) < 0.05, (got["loss"], want["loss"])
    params = dict(named_leaves(got["params"]))
    assert params.keys() == want["params"].keys()
    for name, value in params.items():
        np.testing.assert_allclose(value.float().numpy(), want["params"][name], rtol=3e-2,
                                   atol=3e-2, err_msg=name)


def assert_prefill_meets_serving_criterion(case: OracleCase) -> None:
    """Every rank's gathered logits within LOGIT_ATOL of the reference's."""
    for r in case.port:
        assert r["logits"].shape == (B, case.cfg.vocab)
        np.testing.assert_allclose(r["logits"].numpy(), case.ref["logits"], rtol=0,
                                   atol=LOGIT_ATOL)
