"""The port's sharding plan against the JAX package's.

* Every Spec of every architecture (full configs, Spec trees only, no
  allocation) carries the reference's logical axes for the same tensor,
  less the leading ``"layers"`` axis where the reference stacks the
  layers (the port keeps one entry a layer; ``convert._stacks`` maps
  the names).  The port's parameter names and the reference's stacked
  leaves match one to one: no leaf is split or merged.
* Over every architecture, every shape of ``SHAPES`` and both production
  meshes (the reference's on ``jax.sharding.AbstractMesh``, the port's
  ``launch.mesh.production_mesh``): ``build_rules``' rules and fallback
  texts, ``param_pspecs``, ``train_state_pspecs`` (exact and int8),
  ``cache_pspecs`` (plain and quantized) and ``batch_pspecs``.
* ``cache_pspecs`` and ``batch_pspecs`` mirror the port's own caches and
  batches (one spec entry a dimension), and the mesh descriptions.

The placement of a plan on ranks runs in the 4-rank world of
``tests/test_torch_grad_aggregation.py``.
"""

import math

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, \
    get_reduced_config
from repro_torch.convert import _stacks
from repro_torch.launch import shardings
from repro_torch.launch.mesh import (
    MeshShape,
    describe,
    mesh_chips,
    production_mesh,
)
from repro_torch.models import build_model
from repro_torch.models.attention import QuantKV
from repro_torch.models.params import Spec, named_specs, param_pspecs
from repro_torch.models.spectral import spectral_specs
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.adamw import QuantMoment
from repro_torch.training import TrainState, train_state_pspecs


@pytest.fixture(scope="module")
def jx():
    """The JAX package's plan and every full model's Spec tree."""
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh, PartitionSpec

    from repro.configs import get_config as jget_config
    from repro.launch import shardings as jshardings
    from repro.models import build_model as jbuild
    from repro.models import params as jparams
    from repro.models.attention import QuantKV as JQuantKV
    from repro.models.spectral import spectral_specs as jspectral_specs
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import adamw as jadamw
    from repro.optim.adamw import QuantMoment as JQuantMoment
    from repro.training.train_state import train_state_pspecs as jtsp

    return {
        "jax": jax, "P": PartitionSpec, "sh": jshardings,
        "params": jparams, "QuantKV": JQuantKV, "QuantMoment": JQuantMoment,
        "spectral_specs": jspectral_specs, "tsp": jtsp,
        "meshes": {False: AbstractMesh((16, 16), ("data", "model")),
                   True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))},
        "opts": {q: jadamw(1e-3, JAdamWConfig(quantized_state=q))
                 for q in (False, True)},
        "cfgs": {a: jget_config(a) for a in ARCH_IDS},
        "specs": {a: jbuild(jget_config(a)).specs for a in ARCH_IDS},
    }


@pytest.fixture(scope="module")
def models():
    return {a: build_model(get_config(a), device="cpu") for a in ARCH_IDS}


def _plain(x, jx):
    """A spec tree as plain python: PartitionSpecs and spec tuples as
    tuples; QuantKV, QuantMoment and Spec (shape and axes) as tagged
    tuples."""
    if isinstance(x, (QuantKV, jx["QuantKV"])):
        return ("QuantKV", _plain(x.q, jx), _plain(x.scale, jx))
    if isinstance(x, (QuantMoment, jx["QuantMoment"])):
        return ("QuantMoment", _plain(x.q, jx), _plain(x.scale, jx))
    if isinstance(x, dict):
        return {k: _plain(v, jx) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v, jx) for v in x]
    if isinstance(x, (Spec, jx["params"].Spec)):
        return ("Spec", tuple(x.shape), tuple(x.axes))
    return tuple(x)


def _drop_lead(x):
    """The plain value less its leading (stacked-layers) entry."""
    if isinstance(x, dict):
        return {k: _drop_lead(v) for k, v in x.items()}
    if x and x[0] in ("QuantKV", "QuantMoment", "Spec"):
        return (x[0], _drop_lead(x[1]), _drop_lead(x[2]))
    return tuple(x[1:])


def _by_port_name(cfg, spec_tree, value_tree, jx) -> dict:
    """The reference's ``value_tree`` (structured as its Spec tree down to
    the Spec leaves) keyed by the port's parameter names: each stacked
    leaf once a layer, less its leading entry."""
    jax = jx["jax"]
    is_spec = lambda x: isinstance(x, jx["params"].Spec)  # noqa: E731
    paths, treedef = jax.tree_util.tree_flatten_with_path(spec_tree,
                                                          is_leaf=is_spec)
    values = treedef.flatten_up_to(value_tree)
    stacks = {key: (prefix, slots, repeats, is_list)
              for prefix, key, slots, repeats, is_list in _stacks(cfg)}
    out = {}
    for (path, _), value in zip(paths, values):
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        value = _plain(value, jx)
        if parts[0] in stacks:
            prefix, slots, repeats, is_list = stacks[parts[0]]
            slot, rest = ((int(parts[1]), parts[2:]) if is_list
                          else (0, parts[1:]))
            for r in range(repeats):
                out[".".join([prefix, str(r * slots + slot)] + rest)] = \
                    _drop_lead(value)
        elif parts[0] == "tail":                # the hybrid's unstacked tail
            prefix, slots, repeats, _ = stacks["blocks"]
            out[".".join([prefix, str(repeats * slots + int(parts[1]))]
                         + parts[2:])] = value
        else:
            out[".".join(parts)] = value
    return out


# --------------------------------------------------------------------------
# the axes of every Spec
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_axes_match_reference(jx, models, arch):
    specs = jx["specs"][arch]
    want = _by_port_name(jx["cfgs"][arch], specs, specs, jx)
    got = _plain(named_specs(models[arch].make_params("meta")), jx)
    assert list(got) == list(models[arch].make_params("meta")
                             .state_dict().keys())
    assert set(got) == set(want), (set(got) ^ set(want))
    bad = {n: (got[n], want[n]) for n in got if got[n] != want[n]}
    assert not bad, bad


def test_spectral_spec_axes_match_reference(jx):
    got = _plain(spectral_specs(64, 32), jx)
    assert got == _plain(jx["spectral_specs"](64, 32), jx)


def test_spec_requires_one_axis_a_dimension():
    with pytest.raises(AssertionError):
        Spec((4, 8), ("p_fsdp",))


# --------------------------------------------------------------------------
# rules, params, train state, caches and batches on the production meshes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_matches_reference(jx, models, arch, shape, multi_pod):
    cfg, jcfg = get_config(arch), jx["cfgs"][arch]
    jspecs, model = jx["specs"][arch], models[arch]
    rules, fallbacks = shardings.build_rules(
        cfg, SHAPES[shape], production_mesh(multi_pod=multi_pod))
    jrules, jfallbacks = jx["sh"].build_rules(jcfg, _jshape(shape),
                                              jx["meshes"][multi_pod])
    assert rules == jrules
    assert fallbacks == jfallbacks

    # parameters: every port leaf its reference leaf's spec, less "layers"
    want = _by_port_name(jcfg, jspecs,
                         jx["params"].param_pspecs(jspecs, jrules), jx)
    got = _plain(param_pspecs(named_specs(model.make_params("meta")),
                              rules), jx)
    assert got == want

    # the training state, exact and int8
    for quant in (False, True):
        ts = train_state_pspecs(model, adamw(1e-3, AdamWConfig(
            quantized_state=quant)), rules)
        jts = jx["tsp"](jspecs, jx["opts"][quant], jrules)
        assert isinstance(ts, TrainState)
        assert ts.step == tuple(jts.step) == ()
        assert ts.opt_state["count"] == tuple(jts.opt_state["count"])
        assert _plain(ts.params, jx) == got
        assert _plain(ts.opt_state["mu"], jx) == _by_port_name(
            jcfg, jspecs, jts.opt_state["mu"], jx)

    # caches, plain and quantized
    for quant in (False, True):
        mine = _plain(shardings.cache_pspecs(cfg, rules, quantized=quant),
                      jx)
        ref = _plain(jx["sh"].cache_pspecs(jcfg, jrules, quantized=quant),
                     jx)
        fam = cfg.family
        if fam in ("dense", "moe", "vlm"):
            assert all(mine == slot for slot in ref)
        elif fam == "ssm":
            assert mine == ref
        elif fam == "encdec":
            assert ref["max_len"] == ()
            assert mine == ref["layers"]
        else:                           # one entry a layer; pattern + tail
            pat = len(cfg.recurrent.block_pattern)
            repeats = cfg.n_layers // pat
            want_layers = [_drop_lead(ref["blocks"][i % pat])
                           for i in range(repeats * pat)] + ref["tail"]
            assert mine == want_layers

    # batches
    assert _plain(shardings.batch_pspecs(cfg, SHAPES[shape], rules), jx) \
        == _plain(jx["sh"].batch_pspecs(jcfg, _jshape(shape), jrules), jx)


def _jshape(name):
    from repro.configs import SHAPES as JSHAPES

    return JSHAPES[name]


# --------------------------------------------------------------------------
# the port's own structures
# --------------------------------------------------------------------------
def _spec_leaves(tree, like):
    """(spec, tensor) pairs of a spec tree and the value tree it mirrors."""
    if isinstance(tree, (QuantKV, QuantMoment)):
        yield from _spec_leaves(tree.q, like.q)
        yield from _spec_leaves(tree.scale, like.scale)
    elif isinstance(tree, dict):
        assert set(tree) == set(like)
        for k in tree:
            yield from _spec_leaves(tree[k], like[k])
    elif isinstance(tree, list):
        assert len(tree) == len(like)
        for a, b in zip(tree, like):
            yield from _spec_leaves(a, b)
    else:
        yield tree, like


@pytest.mark.parametrize("arch", ["gemma-2b", "dbrx-132b", "rwkv6-3b",
                                  "recurrentgemma-9b", "whisper-medium"])
def test_cache_and_batch_specs_mirror_the_port(arch):
    cfg = get_reduced_config(arch)
    model = build_model(cfg, device="cpu")
    for shape in ("decode_32k", "prefill_32k"):
        rules, _ = shardings.build_rules(cfg, SHAPES[shape],
                                         production_mesh())
        quants = (False, True) if cfg.family in ("dense", "moe") \
            else (False,)
        for quant in quants:
            cache = model.init_cache(2, 16, quantized=quant)
            pairs = list(_spec_leaves(
                shardings.cache_pspecs(cfg, rules, quantized=quant), cache))
            assert pairs and all(len(s) == t.dim() for s, t in pairs)
        small = type(SHAPES[shape])(shape, 32, 2, SHAPES[shape].kind)
        batch = model.input_specs(small)
        specs = shardings.batch_pspecs(cfg, small, rules)
        assert set(specs) == set(batch)
        assert all(len(specs[k]) == batch[k].dim() for k in batch)


def test_train_state_specs_mirror_the_state():
    """Keyed as the port's state, one entry a dimension; int8 scales one
    entry a dimension of the scale."""
    from repro_torch.training import abstract_train_state

    model = build_model(get_reduced_config("dbrx-132b"), device="cpu")
    rules, _ = shardings.build_rules(model.cfg, SHAPES["train_4k"],
                                     production_mesh(multi_pod=True))
    for quant in (False, True):
        opt = adamw(1e-3, AdamWConfig(quantized_state=quant))
        ts = train_state_pspecs(model, opt, rules)
        st = abstract_train_state(model, opt)
        params = dict(st.params.named_parameters())
        assert list(ts.params) == list(params)
        assert all(len(ts.params[n]) == p.dim() for n, p in params.items())
        pairs = list(_spec_leaves(ts.opt_state["mu"], st.opt_state["mu"]))
        assert len(pairs) == 4 * len(params) if quant else 2 * len(params)
        assert all(len(s) == t.dim() for s, t in pairs)


def test_production_meshes(jx):
    for multi_pod, jmesh in jx["meshes"].items():
        mesh = production_mesh(multi_pod=multi_pod)
        assert mesh.shape == dict(jmesh.shape)
        assert mesh.axis_names == tuple(jmesh.axis_names)
        assert mesh_chips(mesh) == math.prod(jmesh.shape.values())
    assert describe(production_mesh()) == MeshShape(("data", "model"),
                                                    (16, 16))
