"""The port's logical-axis sharding (``repro_torch.parallel.sharding``) and
the ``*_shardings`` of ``repro_torch.launch.steps`` against the JAX
package's.

* The six rule sets equal the reference's, entry for entry.
* For every architecture of ``ARCH_IDS`` at full width (shapes only: no
  parameter is made), every rule set and the meshes 16x16, 2x16x16, 2x2 and
  1x4: every parameter leaf's fitted ``PartitionSpec`` equals the
  reference's, and so do the ``train_shardings`` (AdamW: parameters, both
  moments and the step; the batch), ``prefill_shardings`` and
  ``decode_shardings`` (the decode state, the tokens) trees of every
  ``INPUT_SHAPES`` entry, with the stand-ins' shapes; and the flat
  buffer's specs.

The reference builds its shardings on ``jax.sharding.AbstractMesh`` (no
devices, nothing compiled); the port on a ``sharding.MeshShape``.
"""
import pytest

import jax
from jax.sharding import AbstractMesh

from repro.configs import base as j_base
from repro.launch import steps as j_steps
from repro.models.model import Model as JModel
from repro.optim import adamw as j_adamw
from repro.parallel import sharding as j_shd

torch = pytest.importorskip("torch")

from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from _model_pair import flat  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
RULES = {"default": (shd.DEFAULT_RULES, j_shd.DEFAULT_RULES),
         "expert_parallel": (shd.EXPERT_PARALLEL_RULES,
                             j_shd.EXPERT_PARALLEL_RULES),
         "no_fsdp": (shd.NO_FSDP_RULES, j_shd.NO_FSDP_RULES),
         "seq_parallel": (shd.SEQ_PARALLEL_RULES, j_shd.SEQ_PARALLEL_RULES),
         "pure_fsdp": (shd.PURE_FSDP_RULES, j_shd.PURE_FSDP_RULES),
         "kv_seq_sharded": (shd.KV_SEQ_SHARDED_RULES,
                            j_shd.KV_SEQ_SHARDED_RULES)}


def _meshes(name):
    sizes, names = MESHES[name]
    return shd.MeshShape(names, sizes), AbstractMesh(sizes, names)


def test_rule_sets_equal_the_reference():
    assert set(shd.RULE_SETS) == set(RULES)
    for name, (t_rules, j_rules) in RULES.items():
        assert shd.RULE_SETS[name] is t_rules
        assert t_rules == j_rules, name
    assert shd.SEQ_SHARDED_RULES == j_shd.SEQ_SHARDED_RULES


def _specs(tree):
    """[(path, spec entries)] of a tree of either package's shardings."""
    return [(p, tuple(s.spec)) for p, s in flat(tree)]


def _shapes(tree):
    return [(p, tuple(x.shape)) for p, x in flat(tree)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", t_base.ARCH_IDS)
def test_shardings_equal_the_reference(arch, mesh_name):
    t_mesh, j_mesh = _meshes(mesh_name)
    t_cfg, j_cfg = t_base.get_config(arch), j_base.get_config(arch)
    for rules_name, (t_rules, j_rules) in RULES.items():
        tm = Model(t_cfg, mesh=t_mesh, rules=t_rules, impl="xla_flash",
                   param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
        jm = JModel(j_cfg, mesh=j_mesh, rules=j_rules,
                    param_dtype=jax.numpy.bfloat16,
                    act_dtype=jax.numpy.bfloat16)
        what = (arch, mesh_name, rules_name)
        t_p = shd.logical_to_sharding(t_mesh, tm.axes(), tm.param_shapes(),
                                      t_rules)
        j_p = j_shd.logical_to_sharding(j_mesh, jm.axes(), jm.param_shapes(),
                                        j_rules)
        assert _specs(t_p) == _specs(j_p), what
        for i, shape_name in enumerate(t_base.INPUT_SHAPES):
            t_shape = t_base.INPUT_SHAPES[shape_name]
            j_shape = j_base.INPUT_SHAPES[shape_name]
            w = what + (shape_name,)
            if i == 0:
                # the parameter and AdamW shardings do not depend on the
                # shape: the whole train tree once a rule set
                t_sh, t_args = t_steps.train_shardings(tm, adamw(1e-4),
                                                       t_shape)
                j_sh, j_args = j_steps.train_shardings(jm, j_adamw(1e-4),
                                                       j_shape)
            else:                                   # its batch part
                t_args = tm.input_specs(t_shape)
                j_args = jm.input_specs(j_shape)
                t_sh = shd.logical_to_sharding(
                    t_mesh, tm.input_axes(t_shape), t_args, t_rules)
                j_sh = j_shd.logical_to_sharding(
                    j_mesh, jm.input_axes(j_shape), j_args, j_rules)
            assert _specs(t_sh) == _specs(j_sh), w + ("train",)
            assert _shapes(t_args) == _shapes(j_args), w + ("train",)
            t_sh, t_args = t_steps.prefill_shardings(tm, t_shape)
            j_sh, j_args = j_steps.prefill_shardings(jm, j_shape)
            assert _specs(t_sh) == _specs(j_sh), w + ("prefill",)
            assert _shapes(t_args) == _shapes(j_args), w + ("prefill",)
            t_sh, t_args = t_steps.decode_shardings(tm, t_shape)
            j_sh, j_args = j_steps.decode_shardings(jm, j_shape)
            assert _specs(t_sh) == _specs(j_sh), w + ("decode",)
            assert _shapes(t_args) == _shapes(j_args), w + ("decode",)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_flat_buffer_specs_equal_the_reference(mesh_name):
    t_mesh, j_mesh = _meshes(mesh_name)
    for t_rules, j_rules in RULES.values():
        for t_fn, j_fn in ((shd.flat_buffer_spec, j_shd.flat_buffer_spec),
                           (shd.flat_buffer_row_spec,
                            j_shd.flat_buffer_row_spec),
                           (shd.flat_buffer_col_spec,
                            j_shd.flat_buffer_col_spec)):
            assert tuple(t_fn(t_mesh, t_rules)) == tuple(j_fn(j_mesh,
                                                              j_rules))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_constrain_points_fit_as_the_reference(mesh_name):
    """``constrain``'s fitted spec of each activation the model constrains
    (queries, MLP hidden, residual) equals the reference's."""
    t_mesh, j_mesh = _meshes(mesh_name)
    shapes = {("batch", "seq", "act_heads", "head_dim"): (256, 4096, 32, 64),
              ("batch", "seq", "mlp"): (256, 4096, 5632),
              ("batch", "act_seq", "act_embed"): (256, 4096, 2048),
              ("batch", "seq", "act_embed"): (2, 4096, 2048)}
    for t_rules, j_rules in RULES.values():
        for axes, shape in shapes.items():
            t = shd._shard_fits(t_mesh, shd.spec_for(t_mesh, axes, t_rules),
                                shape)
            j = j_shd._shard_fits(j_mesh, j_shd.spec_for(j_mesh, axes,
                                                         j_rules), shape)
            assert tuple(t) == tuple(j), (axes, shape)


def test_placements_shard_each_dim_over_its_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = shd.MeshShape(("pod", "data", "model"), (2, 16, 16))
    s = shd.NamedSharding(mesh, shd.P(("pod", "data"), None, "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    assert s.shard_shape((64, 7, 32)) == (2, 7, 2)
    assert shd.NamedSharding(mesh, shd.P()).placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's axis order"):
        shd.placements_for(mesh, shd.P(("data", "pod")))
