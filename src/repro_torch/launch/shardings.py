"""Per-cell sharding plans: rules with divisibility fallbacks + state specs.

The production mesh is fixed at (data=16, model=16) [x pod=2], but not
every architecture dimension divides every axis (qwen1.5's 40 heads vs a
16-way model axis; whisper's 51865 vocab; long_500k's batch of 1).
``build_rules`` starts from the global rules table and *falls back to
replication* for any logical axis whose dimension does not divide its
mesh axis, recording each fallback, as the JAX package's plan does.

Also here: the PartitionSpec trees of the KV/recurrent caches and of a
batch, mirroring the port's structures.  A spec is the port's tuple
(``distributed.sharding``); :func:`to_named` turns a spec tree into
DTensor placements on a ``DeviceMesh``.  The port keeps one entry a
layer where the reference stacks the layers on a leading axis; where the
port's cache is stacked too (the transformer's K/V, RWKV-6's state, the
encoder-decoder's self and cross K/V), its spec keeps that leading
``"layers"`` entry, which every rules table maps to ``None``.

``mesh`` here is anything with ``.shape`` (name -> size) and
``.axis_names``: ``launch.mesh.production_mesh()``, or a ``DeviceMesh``
through ``launch.mesh.describe``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    MULTI_POD_RULES,
    SINGLE_POD_RULES,
    AxisRules,
    logical_spec,
    spec_placements,
)
from repro_torch.launch.mesh import describe
from repro_torch.models.attention import QuantKV
from repro_torch.optim.adamw import QuantMoment
from repro_torch.training.train_state import TrainState

__all__ = ["ShardingPlan", "build_rules", "make_plan", "cache_pspecs",
           "batch_pspecs", "to_named"]


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        out = 1
        for a in entry:
            out *= mesh.shape[a]
        return out
    return mesh.shape[entry]


def build_rules(cfg: ArchConfig, shape: ShapeConfig, mesh
                ) -> tuple[AxisRules, list[str]]:
    """Rules table specialised to (arch, shape, mesh) + fallback log."""
    if not hasattr(mesh, "axis_names"):          # a DeviceMesh
        mesh = describe(mesh)
    base = MULTI_POD_RULES if "pod" in mesh.axis_names else SINGLE_POD_RULES
    rules = dict(base)
    fallbacks: list[str] = []

    def require(axis: str, dim: int, what: str):
        size = _axis_size(mesh, rules.get(axis))
        if size > 1 and dim % size != 0:
            rules[axis] = None
            fallbacks.append(
                f"{axis}: {what}={dim} % {size} != 0 -> replicated")

    # batch: drop "pod" first, then all, if the global batch doesn't divide
    bsz = shape.global_batch
    nbatch = _axis_size(mesh, rules["batch"])
    if nbatch > 1 and bsz % nbatch != 0:
        if "pod" in mesh.axis_names and bsz % mesh.shape["data"] == 0:
            rules["batch"] = "data"
            fallbacks.append(
                f"batch: {bsz} not divisible by pod*data -> data only")
        else:
            rules["batch"] = None
            fallbacks.append(f"batch: {bsz} not divisible -> replicated")

    require("heads", cfg.n_heads, "n_heads")
    require("p_heads", cfg.n_heads, "n_heads")
    # the attention-free family names no K/V heads; the reference's
    # config gives it n_kv_heads = n_heads
    kv = cfg.n_heads if cfg.n_kv_heads is None else cfg.n_kv_heads
    require("kv_heads", kv, "n_kv_heads")
    require("p_kv", kv, "n_kv_heads")
    require("vocab", cfg.vocab_size, "vocab")
    require("p_vocab", cfg.vocab_size, "vocab")
    mlp_dims = [cfg.d_ff]
    if cfg.moe is not None:
        mlp_dims.append(cfg.moe.d_ff_expert)
    if cfg.recurrent is not None:
        mlp_dims.append(cfg.recurrent.d_rnn)
    for dim in mlp_dims:
        require("mlp", dim, "ff/rnn width")
        require("p_mlp", dim, "ff/rnn width")
    if cfg.moe is not None:
        require("experts", cfg.moe.num_experts, "num_experts")
        require("p_experts", cfg.moe.num_experts, "num_experts")
    # FSDP axis shards d_model slices of params
    require("p_fsdp", cfg.d_model, "d_model")

    # KV-cache context parallelism: when kv_heads cannot occupy the model
    # axis (GQA kv < 16 or non-divisible), shard the cache's SEQUENCE axis
    # over "model" instead -- otherwise 32k-decode caches replicate 16x
    # (qwen1.5-32b: 86 GB a chip replicated against 5.4 GB sharded).
    if rules.get("kv_heads") is None and shape.kind in ("prefill", "decode"):
        cache_len = shape.seq_len if cfg.attn_window is None else min(
            shape.seq_len, cfg.attn_window)
        model_size = mesh.shape.get("model", 1)
        if model_size > 1 and cache_len % model_size == 0:
            rules["kv_seq"] = "model"
            fallbacks.append(
                f"kv_seq: cache seq axis -> model ({cache_len} % "
                f"{model_size} == 0; "
                "context-parallel KV since kv_heads replicated)")

    # flattened token axis (MoE dispatch) follows the batch axis decision
    rules["tokens"] = rules["batch"]
    return rules, fallbacks


# --------------------------------------------------------------------------
# cache PartitionSpec trees (mirror each family's init_cache structure)
# --------------------------------------------------------------------------
def _kv_slot(rules: AxisRules, lead: tuple[str, ...], quantized: bool):
    spec = logical_spec(lead + ("batch", "kv_seq", "kv_heads", None), rules)
    if quantized:      # the scale: the same layout, its last dim 1
        return {"k": QuantKV(q=spec, scale=spec),
                "v": QuantKV(q=spec, scale=spec)}
    return {"k": spec, "v": spec}


def cache_pspecs(cfg: ArchConfig, rules: AxisRules, *,
                 quantized: bool = False):
    """The spec tree of ``build_model(cfg).init_cache(...)``: the
    transformer's ``{"k", "v"}`` (layers, B, C, KH, hd), RWKV-6's stacked
    state, the hybrid's list of per-layer states, the encoder-decoder's
    ``{"self", "cross"}``; ``quantized``: each K/V a QuantKV of specs."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return _kv_slot(rules, ("layers",), quantized)
    if fam == "ssm":
        return {
            "tm_last": logical_spec(("layers", "batch", None), rules),
            "cm_last": logical_spec(("layers", "batch", None), rules),
            "wkv": logical_spec(("layers", "batch", "heads", None, None),
                                rules),
        }
    if fam == "hybrid":
        from repro_torch.models.rglru import layer_kinds

        def slot(kind):
            if kind == "attn":
                return _kv_slot(rules, (), quantized)
            return {"conv": logical_spec(("batch", None, "mlp"), rules),
                    "h": logical_spec(("batch", "mlp"), rules)}

        return [slot(kind) for kind in layer_kinds(cfg)]
    if fam == "encdec":
        kv = _kv_slot(rules, ("layers",), quantized)
        return {"self": dict(kv), "cross": dict(kv)}
    raise ValueError(fam)


def batch_pspecs(cfg: ArchConfig, shape: ShapeConfig, rules: AxisRules
                 ) -> dict:
    """The spec of each input of a ``shape`` batch (``input_specs``'s
    keys): tokens and labels (B, T), frames or patches (B, T, D)."""
    b = logical_spec(("batch",), rules)[0]
    tok = (b, None)
    emb = (b, None, None)
    if shape.kind == "train":
        out = {"tokens": tok, "labels": tok}
    elif shape.kind == "prefill":
        out = {"tokens": tok}
    else:
        return {"tokens": tok}
    if cfg.family == "encdec":
        out["frames"] = emb
    if cfg.family == "vlm":
        out["patches"] = emb
    return out


# --------------------------------------------------------------------------
# spec trees -> placements
# --------------------------------------------------------------------------
def _map_specs(fn, tree):
    """``fn`` of every spec in a tree of dicts, lists, TrainStates,
    QuantMoments and QuantKVs whose leaves are spec tuples."""
    if isinstance(tree, TrainState):
        return TrainState(step=fn(tree.step),
                          params=_map_specs(fn, tree.params),
                          opt_state=_map_specs(fn, tree.opt_state))
    if isinstance(tree, QuantMoment):
        return QuantMoment(q=fn(tree.q), scale=fn(tree.scale))
    if isinstance(tree, QuantKV):
        return QuantKV(q=fn(tree.q), scale=fn(tree.scale))
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    return fn(tree)


def to_named(mesh, spec_tree):
    """Spec tree -> the same tree of DTensor placement lists on the
    ``DeviceMesh`` ``mesh`` (``distributed.sharding.place`` takes each)."""
    return _map_specs(lambda s: spec_placements(s, mesh), spec_tree)


@dataclasses.dataclass
class ShardingPlan:
    mesh: Any
    rules: AxisRules
    fallbacks: list[str]
    cfg: ArchConfig
    shape: ShapeConfig

    def named(self, spec_tree):
        return to_named(self.mesh, spec_tree)


def make_plan(cfg: ArchConfig, shape: ShapeConfig, mesh) -> ShardingPlan:
    rules, fallbacks = build_rules(cfg, shape, mesh)
    return ShardingPlan(mesh=mesh, rules=rules, fallbacks=fallbacks,
                        cfg=cfg, shape=shape)
