"""The port's placement rules (``repro_torch.launch.sharding``,
``repro_torch.models.sharding_rules``) against the JAX package's, and its
placement of arrays on a mesh (``core.distributed.place`` / ``gather``).

* Every parameter's spec, the float32 moments', the int8 moments' (codes
  and scales), the error feedback's, for all eleven configs at full width
  (the port's model built on the ``meta`` device), on the test meshes
  (4, 2) and (2, 2, 2) and the production meshes (16, 16) and
  (2, 16, 16), under the rule sets ``{}``, ``{"expert": "model"}`` and
  ``{"no_fsdp": True}``: equal leaf by leaf, a block parameter taking its
  stacked JAX leaf's spec without the repeat dim (which JAX never
  splits).
* ``sharding_rules.spec_for`` equal to the spec JAX's ``shard`` builds
  (caught by patching ``jax.lax.with_sharding_constraint``): the tuple
  filter, axes that do not divide, the EP dedup; ``logical_to_spec``
  equal to JAX's.
* The resident bytes of each device after placing the reduced
  spadas_trajlm's params and float32 moments on (4, 2): the port's
  blocks against the JAX mesh state's ``addressable_shards``.

The JAX side runs in one ``conftest.run_py`` subprocess with 512 forced
host devices (~10 s): the production meshes are built over them, the
test meshes over the first 8 (``jax.sharding.Mesh`` over a slice of
``jax.devices()``, a test-side choice).
"""
import functools
import json

import numpy as np
import pytest
import torch

from conftest import run_py
from repro_torch import configs
from repro_torch.core import distributed as dist
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.models import convert, sharding_rules
from repro_torch.models.model import LanguageModel
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from torch_lm_parity import one_torch_thread  # noqa: F401

RULE_SETS = [{}, {"expert": "model"}, {"no_fsdp": True}]
#: spec_for's rule sets: the three above, and sequence / cache-time axes
#: mapped to "model" (where they meet "tp", the first name keeps the axis)
SPEC_RULE_SETS = RULE_SETS + [{"seq": "model", "kvseq": "model"}]
SPEC_CASES = [
    ((8, 64), ("batch", "seq")),
    ((6, 64), ("batch", "seq")),
    ((2, 64, 32), ("batch", "seq", "tp")),
    ((16, 8, 4, 64), ("batch", "kvseq", "kv", None)),
    ((8, 16, 32), ("expert", "batch", "tp")),
    ((32, 32), ("tp", "fsdp")),
    ((7, 3), ("tp", "fsdp")),
    ((1, 64, 96), ("batch", "seq", "tp")),
]
MESHES = {"test": (False, (4, 2)), "test_multi": (True, (2, 2, 2)),
          "single": (False, (16, 16)), "multi": (True, (2, 16, 16))}

_JAX = """
import json
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from repro import configs
from repro.launch import mesh as jmesh, sharding as jsh, specs
from repro.models import sharding_rules as jsr
from repro.train import optimizer as jopt, train_step as jts

RULE_SETS = %(rules)s
SPEC_RULE_SETS = %(spec_rules)s
SPEC_CASES = %(cases)s
devs = np.array(jax.devices())
meshes = {
    "test": JMesh(devs[:8].reshape(4, 2), ("data", "model")),
    "test_multi": JMesh(devs[:8].reshape(2, 2, 2), ("pod", "data", "model")),
    "single": JMesh(devs[:256].reshape(16, 16), ("data", "model")),
    "multi": jmesh.make_production_mesh(multi_pod=True),
}

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def flat(tree):
    out = {}
    def one(path, s):
        if isinstance(s, jopt.QTensor):
            out[jsh._path_str(path)] = {"codes": enc(s.codes.spec),
                                        "scales": enc(s.scales.spec)}
        else:
            out[jsh._path_str(path)] = enc(s.spec)
    jax.tree_util.tree_map_with_path(one, tree, is_leaf=lambda x: isinstance(
        x, (jopt.QTensor, jax.sharding.NamedSharding)))
    return out

res = {"trees": {}, "spec_for": {}, "logical": {}}
key = jax.random.PRNGKey(0)
for arch in configs.ARCH_IDS:
    cfg = configs.get(arch)
    params = specs.abstract_params(cfg)
    f32 = jax.eval_shape(lambda: jts.init_train_state(
        key, cfg, jopt.OptConfig(), compress=True))
    i8 = jax.eval_shape(lambda: jts.init_train_state(
        key, cfg, jopt.OptConfig(state_dtype="int8")))
    for mname, mesh in meshes.items():
        for ri, rules in enumerate(RULE_SETS):
            res["trees"]["%%s|%%s|%%d" %% (arch, mname, ri)] = {
                "params": flat(jsh.param_shardings(params, mesh, rules)),
                "m": flat(jsh.param_shardings(f32.opt.m, mesh, rules)),
                "err": flat(jsh.param_shardings(f32.err, mesh, rules)),
                "m8": flat(jsh.param_shardings(i8.opt.m, mesh, rules)),
                "v8": flat(jsh.param_shardings(i8.opt.v, mesh, rules)),
            }

caught = []
jax.lax.with_sharding_constraint = (
    lambda x, s: caught.append(enc(s.spec)) or x)
saved = dict(jsr._RULES)
for shape, axes in SPEC_CASES:
    x = jnp.zeros(shape)
    jsr.set_mesh(None)
    caught.clear()
    jsr.shard(x, *axes)
    res["spec_for"]["%%s|none|0" %% (shape,)] = caught[0] if caught else None
    for mname, mesh in meshes.items():
        jsr.set_mesh(mesh)
        for ri, rules in enumerate(SPEC_RULE_SETS):
            jsr._RULES.clear()
            jsr._RULES.update(saved)
            jsr.set_rules(**rules)
            caught.clear()
            jsr.shard(x, *axes)
            res["spec_for"]["%%s|%%s|%%d" %% (shape, mname, ri)] = caught[0]
            res["logical"]["%%s|%%d" %% (axes, ri)] = enc(
                jsr.logical_to_spec(axes))
jsr._RULES.clear()
jsr._RULES.update(saved)

# the reduced spadas_trajlm's state placed on (4, 2): params and the
# float32 moments by the parameter rules, as specs.make_plan places them
cfg = configs.get_reduced("spadas_trajlm")
mesh = meshes["test"]
st = jts.init_train_state(key, cfg, jopt.OptConfig())
placed = []
for tree in (st.params, st.opt.m, st.opt.v):
    shard = jsh.param_shardings(jax.eval_shape(lambda: tree), mesh)
    placed += jax.tree.leaves(jax.tree.map(jax.device_put, tree, shard))
res["bytes"] = [sum(s.data.nbytes for x in placed for s in x.addressable_shards
                    if s.device == d) for d in mesh.devices.flat]
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_specs():
    code = _JAX % {"rules": repr(RULE_SETS),
                   "spec_rules": repr(SPEC_RULE_SETS),
                   "cases": repr(SPEC_CASES)}
    return json.loads(run_py(code, devices=512).strip().splitlines()[-1])


def _mesh(name):
    multi, shape = MESHES[name]
    n = int(np.prod(shape))
    make = (mesh_lib.make_test_mesh if name.startswith("test")
            else mesh_lib.make_production_mesh)
    mesh = make(multi_pod=multi, devices=["cpu"] * n)
    assert tuple(mesh.shape.values()) == shape
    return mesh


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    """The port's params, float32 moments, int8 moments and error
    feedback of ``arch`` at full width, as meta tensors."""
    model = LanguageModel(configs.get(arch), device="meta")
    params = dict(model.named_parameters())
    ranks = convert.jax_ranks(params)
    return {"params": params,
            "m": topt.init_state(params, topt.OptConfig(), ranks=ranks).m,
            "err": comp.init_error(params),
            "m8": topt.init_state(params, topt.OptConfig(state_dtype="int8"),
                                  ranks=ranks).m}


def _norm(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _want(entry, stacked):
    """A JAX leaf's spec as the port's per-repeat tensor must have it."""
    spec = _norm(entry)
    if stacked and spec:
        assert spec[0] is None, spec      # JAX never splits the repeats
        spec = spec[1:]
    return spec


def _check_tree(port: dict, want: dict):
    """Port shardings (name -> NamedSharding or QTensor of them) against
    the JAX specs of the same tree (JAX leaf key -> spec, or codes and
    scales), leaf by leaf; every JAX leaf is covered."""
    assert {convert.jax_key(n)[0] for n in port} == set(want)
    for n, s in port.items():
        key, r = convert.jax_key(n)
        w = want[key]
        if isinstance(w, dict):
            assert isinstance(s, topt.QTensor), n
            for part in ("codes", "scales"):
                got = _norm(getattr(s, part).spec)
                assert got == _want(w[part], r is not None), (n, part)
        else:
            assert not isinstance(s, topt.QTensor), n
            assert _norm(s.spec) == _want(w, r is not None), n


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_match_jax(jax_specs, arch, mesh_name):
    """Params, float32 moments, int8 codes and scales and the error
    feedback, under each rule set; the int8 shardings the placed state
    uses (derived from the params') equal them too."""
    trees = _port_trees(arch)
    mesh = _mesh(mesh_name)
    for ri, rules in enumerate(RULE_SETS):
        want = jax_specs["trees"][f"{arch}|{mesh_name}|{ri}"]
        p_shard = sh.param_shardings(trees["params"], mesh, rules)
        _check_tree(p_shard, want["params"])
        _check_tree(sh.param_shardings(trees["m"], mesh, rules), want["m"])
        _check_tree(sh.param_shardings(trees["err"], mesh, rules),
                    want["err"])
        _check_tree(sh.param_shardings(trees["m8"], mesh, rules), want["m8"])
        assert want["v8"] == want["m8"]
        _check_tree(tts._state_shardings(trees["m8"], p_shard), want["m8"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_for_matches_jax_shard(jax_specs, mesh_name):
    mesh = _mesh(mesh_name)
    saved = sharding_rules.get_rules()

    def reset():
        sharding_rules.set_mesh(None)
        sharding_rules._RULES.clear()
        sharding_rules.set_rules(**saved)

    try:
        for shape, axes in SPEC_CASES:
            assert sharding_rules.spec_for(shape, *axes) is None
            assert jax_specs["spec_for"][f"{shape}|none|0"] is None
            for ri, rules in enumerate(SPEC_RULE_SETS):
                sharding_rules.set_rules(**rules)
                want = jax_specs["spec_for"][f"{shape}|{mesh_name}|{ri}"]
                got = sharding_rules.spec_for(shape, *axes, mesh=mesh)
                assert _norm(got) == _norm(want), (shape, axes, rules)
                assert _norm(sharding_rules.logical_to_spec(axes)) == _norm(
                    jax_specs["logical"][f"{axes}|{ri}"])
                sharding_rules.set_mesh(mesh)      # the active mesh alike
                assert sharding_rules.spec_for(shape, *axes) == got
                reset()
    finally:
        reset()


def test_device_bytes_match_jax(jax_specs):
    cfg = configs.get_reduced("spadas_trajlm")
    mesh = _mesh("test")
    st = tts.init_train_state(cfg, topt.OptConfig(), device="cpu")
    p_shard = sh.param_shardings(dict(st.params.named_parameters()), mesh)
    ms = tts.shard_state(st, p_shard)
    got = sh.tree_bytes(ms.params.tensors, ms.opt.m, ms.opt.v)
    assert got == jax_specs["bytes"]
    assert tts.state_device_bytes(ms) == got          # no error feedback
    whole = sum(p.numel() for p in st.params.parameters()) * 4 * 3
    assert whole < sum(got) < 8 * whole             # some leaves replicate


def test_place_and_gather():
    """Blocks by the spec, copies where coordinates share a block, the
    whole array back bitwise; a spec that does not divide raises."""
    mesh = dist.grid_mesh((2, 2, 2), ("pod", "data", "model"),
                          ["cpu"] * 8, "test")
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    s = dist.NamedSharding(mesh, dist.PartitionSpec(("pod", "data"), "model"))
    placed = dist.place(x, s)
    assert [tuple(b.shape) for b in placed.shards] == [(2, 3, 4)] * 8
    coords = dist.mesh_coords(mesh)
    for c, b in zip(coords, placed.shards):
        row = (2 * c["pod"] + c["data"]) * 2
        col = 3 * c["model"]
        assert torch.equal(b, x[row:row + 2, col:col + 3])
    assert torch.equal(dist.gather(placed), x)
    rep = dist.place(x, dist.NamedSharding(mesh, dist.PartitionSpec()))
    assert all(torch.equal(b, x) for b in rep.shards)
    assert len({b.data_ptr() for b in rep.shards}) == 8     # copies
    rep.shards[3].zero_()
    assert torch.equal(dist.gather(rep), x)     # the first holder's block
    dist.write(placed, x + 1)
    assert torch.equal(dist.gather(placed), x + 1)
    assert dist.tree_bytes({"x": placed, "r": rep}) == [
        (2 * 3 * 4 + x.numel()) * 4] * 8
    with pytest.raises(ValueError, match="does not split"):
        dist.place(x, dist.NamedSharding(mesh, dist.PartitionSpec(
            None, ("pod", "data", "model"))))
    with pytest.raises(ValueError, match="two"):
        dist.place(x, dist.NamedSharding(mesh, dist.PartitionSpec(
            "data", "data")))


def test_meshes_are_device_grids():
    """The test and production grids over a list; a short list raises
    (never a smaller mesh), as does no card without a list."""
    assert _mesh("test").axis_names == ("data", "model")
    assert _mesh("multi").axis_names == ("pod", "data", "model")
    grid = mesh_lib.make_test_mesh(devices=["cpu"] * 9)
    assert len(grid.flat) == 8
    with pytest.raises(ValueError, match="devices="):
        mesh_lib.make_production_mesh(devices=["cpu"] * 255)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_lib.make_test_mesh()


def test_batch_specs():
    mesh = _mesh("test_multi")
    assert sh.batch_axes(mesh) == ("pod", "data")
    assert sh.spec_for_batch_leaf((8, 64), mesh) == (("pod", "data"), None)
    assert sh.spec_for_batch_leaf((6, 64), mesh) == (None, None)
    assert sh.spec_for_batch_leaf((), mesh) == ()
