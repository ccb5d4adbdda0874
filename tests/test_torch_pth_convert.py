"""Reading and writing the reference's ``.pth`` checkpoints in the port
(``mft_tpu_torch/models/raft/convert.py``, ``wrapper.py load_weights``)
against the JAX package's converter (``mft_tpu/models/raft/convert.py``).

No reference model is in the repository to give a template of its names, so
JAX's forward converter is the oracle for them: it raises ``KeyError`` on
any name it does not map. From seeded variables of JAX's tree (the big and
the small model), the port's export, with and without ``module.``:

- is accepted key for key by JAX's ``torch_statedict_to_variables``, which
  gives back exactly the variables it came from;
- equals, tensor for tensor, what JAX's ``variables_to_torch_statedict``
  writes with the export as its template;
- loads through the port's ``load_weights`` to exactly
  ``params_from_flax(variables)``.

The port's CLI writes the same msgpack bytes as JAX's ``convert.main``; a
tracker frame from a ``.pth`` equals one from the msgpack it came from; a
name that neither form knows raises.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mft_tpu.models.raft import convert as jax_convert
from mft_tpu.models.raft.raft import RAFT as JaxRAFT
from mft_tpu.models.raft.wrapper import raft_params_from_config as jax_raft_params
from mft_tpu_torch import config as port_config
from mft_tpu_torch.models.raft import convert
from mft_tpu_torch.models.raft.flax_msgpack import dumps, read_variables
from mft_tpu_torch.models.raft.wrapper import load_weights
from mft_tpu_torch.tracker import MFT

REPO = Path(__file__).resolve().parents[1]
WEIGHTS = REPO / "weights" / "raftou_synth.msgpack"
VARIANTS = {"big": {}, "small": {"small": True}, "morelayers": {
    "occlusion_module": "separate_with_uncertainty_morelayers"}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops (6 xdist workers
    share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.fixture(scope="module")
def variables():
    """{variant: JAX variables of its tree} with seeded values (numpy
    float32): the tree from ``jax.eval_shape`` of JAX's init, each leaf
    filled from one generator."""
    out = {}
    rng = np.random.default_rng(0)
    for name, params in VARIANTS.items():
        model = JaxRAFT(jax_raft_params({"occlusion_module": "separate_with_uncertainty",
                                         **params}))
        dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), dummy, dummy, iters=1))
        out[name] = jax.tree.map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32), dict(shapes))
    return out


def _assert_same_tree(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=str(k))


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "module"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_export_round_trips_through_jax(tmp_path, variables, variant, prefix):
    var = variables[variant]
    state = convert.params_from_flax(var)
    path = tmp_path / "ref.pth"
    convert.export_torch_checkpoint(state, path, module_prefix=prefix)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    assert all(k.startswith("module.") == prefix for k in sd)
    assert convert.is_reference_state_dict(sd) and not convert.is_reference_state_dict(state)
    # JAX's forward converter accepts every key and gives back the variables
    _assert_same_tree(jax_convert.torch_statedict_to_variables(sd), var)
    # JAX's inverse, with the export as its template, writes the same tensors
    back = jax_convert.variables_to_torch_statedict(var, sd)
    assert list(back) == list(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy(), err_msg=k)
    # the port reads it to exactly params_from_flax(variables)
    got = load_weights(path)
    assert sorted(got) == sorted(state)
    for k in state:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], state[k]), k
    assert convert.variables_from_reference(sd).keys() == var.keys()
    _assert_same_tree(convert.variables_from_reference(sd), var)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cli_writes_jax_bytes(tmp_path, variables, variant):
    """``python -m mft_tpu_torch.models.raft.convert in.pth out.msgpack``
    writes the bytes of JAX's ``convert.main`` on the same file."""
    path = tmp_path / "ref.pth"
    convert.export_torch_checkpoint(convert.params_from_flax(variables[variant]), path)
    jax_convert.main([str(path), str(tmp_path / "jax.msgpack")])
    convert.main([str(path), str(tmp_path / "port" / "port.msgpack")])
    want = (tmp_path / "jax.msgpack").read_bytes()
    assert (tmp_path / "port" / "port.msgpack").read_bytes() == want
    _assert_same_tree(read_variables(tmp_path / "jax.msgpack"), variables[variant])


def test_names_neither_form_knows_raise(tmp_path, variables):
    state = convert.params_from_flax(variables["big"])
    ref = convert.reference_state_dict(state, module_prefix=True)
    for bad in ("module.fnet.layer1.0.conv9.weight", "module.update_block.mask.4.weight",
                "module.occlusion_block.occl_head.model.x.weight", "module.extra.weight"):
        torch.save({**ref, bad: torch.zeros(1)}, tmp_path / "bad.pth")
        with pytest.raises(KeyError):
            load_weights(tmp_path / "bad.pth")
        with pytest.raises(KeyError):       # JAX's converter refuses it too
            jax_convert.torch_statedict_to_variables({**ref, bad: np.zeros(1)})
    # the port's own form with a name the model lacks: the strict load raises
    torch.save({**state, "update_block.extra.weight": torch.zeros(1)}, tmp_path / "own.pth")
    conf = port_config.synth_flow_config()
    conf.model = str(tmp_path / "own.pth")
    from mft_tpu_torch.models.raft import RAFTFlow
    with pytest.raises(RuntimeError, match="extra"):
        RAFTFlow(conf, device="cpu")


def test_tracker_frame_from_pth_equals_msgpack(tmp_path):
    """The committed weights as a reference ``.pth`` (DataParallel names)
    and as their msgpack: a tracker's frames bit for bit alike (CPU, 64x64,
    3 iterations)."""
    path = tmp_path / "raftou_synth.pth"
    convert.export_torch_checkpoint(convert.params_from_flax(read_variables(WEIGHTS)), path)
    rng = np.random.default_rng(3)
    tex = (rng.random((72, 72, 3)) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(tex[k:k + 64, 2 * k:2 * k + 64]) for k in range(3)]
    outs = []
    for model in (WEIGHTS, path):
        cfg = port_config.synth_config()
        cfg.flow_config.model = str(model)
        cfg.flow_config.flow_iters = 3
        cfg.flow_config.raft_params = {**cfg.flow_config.raft_params,
                                       "compute_dtype": "float32"}
        tracker = MFT(cfg, device="cpu")
        res = [tracker.init(frames[0]).result] + [tracker.track(f).result for f in frames[1:]]
        outs.append([(r.flow.numpy(), r.occlusion.numpy(), r.sigma.numpy()) for r in res])
    for a, b in zip(*outs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_writer_packs_ints_as_msgpack_does():
    """The writer packs an int in its smallest form, as the msgpack package
    does (array shapes in the ndarray payloads among them), so its files'
    bytes equal flax's."""
    import msgpack
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1,
            -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    obj = {"ints": ints, "nested": {"a": [300, {"b": -200}], "s": "x" * 40}}
    assert dumps(obj) == msgpack.packb(obj, use_bin_type=True)
