"""The port's sharded layout (``repro_torch.sharding.rules``) against the
JAX package's ``repro.sharding.rules``.

- The five rule tables and ``RULE_SETS`` equal the JAX ones.
- For every arch of ``list_archs()``, every rule set and both production
  meshes (16 x 16 ``data, model`` and 2 x 16 x 16 ``pod, data, model``),
  each parameter's DTensor placements, read back as a spec, equal the JAX
  ``repair_pspec(d.shape, rules.pspec(d.axes, mesh), mesh)`` on a
  ``jax.sharding.AbstractMesh`` (no devices).  The port's meshes are real
  ``DeviceMesh``es of 256 and 512 ranks on ``torch.distributed``'s fake
  backend, built in a subprocess (the fake process group is global state
  this process keeps out of).
- ``constrain`` is a no-op without a mesh, ``repair_pspec`` moves an
  indivisible assignment as the reference does, and ``distribute`` keeps
  each rank's ``torch.chunk`` slice of uneven dims.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.api import get_model as jax_get_model
from repro.sharding import rules as jax_rules
from repro_torch.configs.base import list_archs
from repro_torch.sharding import rules

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
RULE_NAMES = ("TRAIN_RULES", "PREFILL_RULES", "TRAIN_TP_REPLICATED",
              "SERVE_RULES", "LONG_DECODE_RULES")

# the port's side: each mesh's placements of every arch under every rule
# set, read back as specs (tensor dim -> the mesh dim names sharding it)
PORT_SPECS = r"""
import json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import get_config, list_archs
from repro_torch.models.api import get_model
from repro_torch.sharding.rules import RULE_SETS


def flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


meshes = json.loads(sys.argv[1])
out = {}
for key, (shape, names) in meshes.items():
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    out[key] = {}
    for arch in list_archs():
        model = get_model(get_config(arch))
        for rname, r in RULE_SETS.items():
            defs = flat(model.param_defs)
            specs = {}
            for path, place in flat(model.param_specs(r, mesh)).items():
                specs[path] = [[names[d] for d, p in enumerate(place)
                                if p.is_shard(i)]
                               for i in range(len(defs[path].shape))]
            out[key][f"{arch}|{rname}"] = specs
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_specs():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", PORT_SPECS,
                          json.dumps(MESHES)], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    return json.loads(res.stdout.strip().splitlines()[-1])


def _norm(entry) -> list:
    """A spec entry as the list of mesh dim names it names."""
    if entry is None:
        return []
    return [entry] if isinstance(entry, str) else list(entry)


@pytest.mark.parametrize("name", RULE_NAMES)
def test_rule_tables_equal_jax(name):
    mine, ref = getattr(rules, name), getattr(jax_rules, name)
    assert mine.name == ref.name
    assert dict(mine.rules) == dict(ref.rules)


def test_rule_sets_equal_jax():
    assert sorted(rules.RULE_SETS) == sorted(jax_rules.RULE_SETS)
    for k, r in rules.RULE_SETS.items():
        assert dict(r.rules) == dict(jax_rules.RULE_SETS[k].rules)


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_placements_equal_jax_specs(port_specs, arch, mesh_key):
    shape, names = MESHES[mesh_key]
    amesh = jax.sharding.AbstractMesh(shape, names)
    defs = jax_get_model(jax_get_config(arch)).param_defs
    flat = jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=lambda x: isinstance(x, jax_rules.ParamDef))[0]
    for rname, r in jax_rules.RULE_SETS.items():
        got = port_specs[mesh_key][f"{arch}|{rname}"]
        want = {}
        for path, d in flat:
            key = "/".join(str(p.key) for p in path)
            spec = jax_rules.repair_pspec(d.shape, r.pspec(d.axes, amesh),
                                          amesh)
            spec = list(spec) + [None] * (len(d.shape) - len(spec))
            want[key] = [_norm(e) for e in spec]
        assert got == want, (arch, mesh_key, rname)


def test_constrain_without_a_mesh_is_the_tensor():
    x = torch.arange(6.0).reshape(2, 3)
    assert rules.constrain(x, ("batch", None), rules.TRAIN_RULES, None) is x


class _Mesh:
    """The two members of a ``DeviceMesh`` the spec helpers read."""

    def __init__(self, shape, names):
        self.mesh_dim_names, self._shape = names, shape

    def size(self, d):
        return self._shape[d]


@pytest.mark.parametrize("shape,spec", [
    ((8, 128), (("model",), None)),         # 8 KV heads over 16: moved
    ((32, 128), ("model", None)),           # divisible: kept
    ((3, 5), ("model", "data")),            # nowhere to go: dropped
])
def test_repair_pspec_equals_jax(shape, spec):
    mesh = _Mesh((16, 16), ("data", "model"))
    amesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    want = jax_rules.repair_pspec(shape, jax.sharding.PartitionSpec(*spec),
                                  amesh)
    got = rules.repair_pspec(shape, spec, mesh)
    assert [_norm(e) for e in got] == [_norm(e) for e in
                                       list(want) + [None] * (
                                           len(shape) - len(want))]


def test_chunk_bounds_are_torch_chunk():
    for n in range(1, 20):
        for parts in range(1, 6):
            sizes = [len(c) for c in torch.arange(n).chunk(parts)]
            sizes += [0] * (parts - len(sizes))
            got = [len(c) for c in torch.arange(n).tensor_split(
                rules._chunk_bounds(n, parts))]
            assert got == sizes, (n, parts)
