"""The committed trained-like weights (``weights/raftou_synth.msgpack``) in
the port, and the port's configurations against ``configs/``.

- ``flax_msgpack.read_variables`` against ``flax.serialization.msgpack_restore``
  on the committed file, leaf for leaf (keys, shapes, dtypes, bytes), and on
  small trees of every msgpack form flax writes; ValueError on what it does
  not read (a truncated stream, another ext code, flax's chunked arrays, a
  reserved byte, trailing bytes, a non-str key);
- ``RAFTFlow`` on ``synth_flow_config()`` against JAX's ``RAFTFlow`` on
  ``configs/flow/raftou_synth.py`` (both load the file), float32;
- a weights file that does not decode raises instead of falling back to
  random weights;
- ``default_config()``, ``synth_config()``, ``fast_config()``,
  ``warm_config()`` and ``demo_cpu_config()`` field for field against the
  configuration files they rebuild.
"""

from pathlib import Path

import msgpack
import numpy as np
import pytest
from flax import serialization

from mft_tpu.config import Config as JaxConfig, load_config
from mft_tpu.models.raft import RAFTFlow as JaxRAFTFlow
from mft_tpu_torch import config as port_config
from mft_tpu_torch.models.raft import RAFTFlow
from mft_tpu_torch.models.raft.flax_msgpack import loads, read_variables

REPO = Path(__file__).resolve().parents[1]
WEIGHTS = REPO / "weights" / "raftou_synth.msgpack"


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_reader_matches_flax_on_committed_weights():
    got = dict(_leaves(read_variables(WEIGHTS)))
    want = dict(_leaves(serialization.msgpack_restore(WEIGHTS.read_bytes())))
    assert list(got) == list(want) and len(got) == 162
    for k, w in want.items():
        g = got[k]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), k
        assert g.tobytes() == w.tobytes(), k
    assert {p[0] for p in got} == {"params", "batch_stats"}


def test_reader_matches_flax_on_small_trees():
    """Every form flax writes for a tree: nested maps, arrays of several
    dtypes and shapes (a 0-d one and an empty one), python scalars of each
    msgpack width, strings, bytes, lists, None and bools."""
    rng = np.random.default_rng(0)
    tree = {
        "a": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
              "bias": np.arange(4, dtype=np.int64)},
        "b": {"x": np.float16(1.5) * np.ones((2, 0), np.float16),
              "y": np.array(3.25, np.float64), "z": np.array([1, 0, 1], np.bool_),
              "u": np.arange(300, dtype=np.uint8).astype(np.uint8)},
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -129,
                 -32769, -2 ** 31 - 1, 2 ** 63 - 1],
        "floats": [0.5, -1e300], "s": "x" * 40, "long": "y" * 70000,
        "raw": b"\x00\x01" * 200, "none": None, "flags": [True, False],
        "many": {str(i): i for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    got, want = loads(data), serialization.msgpack_restore(data)
    assert len(list(_leaves(got))) == len(list(_leaves(want)))
    for (kg, g), (kw, w) in zip(_leaves(got), _leaves(want)):
        assert kg == kw
        if isinstance(w, np.ndarray):
            assert (g.shape, g.dtype, g.tobytes()) == (w.shape, w.dtype, w.tobytes()), kg
        else:
            assert g == w and type(g) is type(w), kg


def _ext(code, payload=b"\x00"):
    return msgpack.packb({"params": {"k": msgpack.ExtType(code, payload)}})


BAD = {
    "truncated": lambda: WEIGHTS.read_bytes()[:-1000],
    "truncated_header": lambda: WEIGHTS.read_bytes()[:3],
    "ext_code_2": lambda: _ext(2),
    "ext_code_3": lambda: serialization.msgpack_serialize({"s": np.float32(1.0)}),
    "chunked": lambda: msgpack.packb({"params": {"k": {
        "__msgpack_chunked_array__": True, "shape": {"0": 2}, "chunks": {}}}}),
    "reserved_byte": lambda: b"\x81\xa1k\xc1",
    "trailing": lambda: msgpack.packb({"a": 1}) + b"\x00",
    "int_key": lambda: msgpack.packb({1: 2}),
    "bad_ndarray": lambda: _ext(1, msgpack.packb([[2, 2], "float32", b"\x00" * 3])),
    "not_a_map": lambda: msgpack.packb([1, 2]),
}


@pytest.mark.parametrize("kind", sorted(BAD))
def test_reader_rejects(tmp_path, kind):
    path = tmp_path / "w.msgpack"
    path.write_bytes(BAD[kind]())
    with pytest.raises(ValueError):
        read_variables(path)


def _synth_flow(cls, make, dtype="float32"):
    conf = make()
    conf.raft_params = dict(conf.raft_params, compute_dtype=dtype)
    conf.flow_iters = 3
    return conf


def _pair(seed=0, size=(64, 60)):
    h, w = size
    rng = np.random.default_rng(seed)
    tex = (rng.random((h + 8, w + 8, 3)) * 255).astype(np.uint8)
    return tex[:h, :w].copy(), tex[3:h + 3, 2:w + 2].copy()


def test_synth_weights_match_jax():
    """Both RAFTFlows load the committed file (JAX through flax's
    from_bytes, the port through its reader and params_from_flax) and
    compute the same flow: float32, 3 iterations, 64x60, 1e-4 absolute,
    1e-5 relative."""
    jf = JaxRAFTFlow(_synth_flow(JaxConfig, lambda: load_config(
        REPO / "configs" / "flow" / "raftou_synth.py")))
    tf = RAFTFlow(_synth_flow(None, port_config.synth_flow_config), device="cpu")
    img1, img2 = _pair()
    jflow, jextra = jf.compute_flow(img1, img2, numpy_out=True)
    tflow, textra = tf.compute_flow(img1, img2, numpy_out=True)
    np.testing.assert_allclose(tflow, jflow, atol=1e-4, rtol=1e-5)
    for k in ("occlusion", "sigma"):
        np.testing.assert_allclose(textra[k], jextra[k], atol=1e-4, rtol=1e-5, err_msg=k)
    sd = tf.model.state_dict()
    k = np.asarray(jf.variables["params"]["fnet"]["conv1"]["kernel"])
    np.testing.assert_array_equal(sd["fnet.conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("kind", ["truncated", "chunked", "ext_code_2"])
def test_corrupt_weights_raise(tmp_path, kind):
    """An existing file that does not decode raises from RAFTFlow; it never
    falls back to random weights (a missing path does, as in JAX)."""
    conf = _synth_flow(None, port_config.synth_flow_config)
    conf.model = str(tmp_path / "w.msgpack")
    Path(conf.model).write_bytes(BAD[kind]())
    with pytest.raises(ValueError):
        RAFTFlow(conf, device="cpu")


def test_unknown_suffix_raises_and_missing_file_is_random(tmp_path, caplog):
    conf = _synth_flow(None, port_config.synth_flow_config)
    conf.model = str(tmp_path / "w.npz")
    Path(conf.model).write_bytes(b"x")
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        RAFTFlow(conf, device="cpu")
    conf.model = str(tmp_path / "absent.msgpack")
    with caplog.at_level("WARNING"):
        RAFTFlow(conf, device="cpu")
    assert "absent.msgpack not found - using random init" in caplog.text


# --------------------------------------------------------------------------- #
# the configurations
# --------------------------------------------------------------------------- #
CONFIGS = {"MFT_cfg": "default_config", "MFT_synth_cfg": "synth_config",
           "MFT_fast_cfg": "fast_config", "MFT_warm_cfg": "warm_config",
           "MFT_demo_cpu_cfg": "demo_cpu_config"}
TRACKER_KEYS = ("deltas", "occlusion_threshold", "flow_iters_schedule",
                "warm_start_inf", "cache_delta_infinity", "timers_enabled", "name")
FLOW_KEYS = ("raft_params", "flow_iters", "flow_cache_dir", "flow_cache_ext")


def _value(v):
    return None if isinstance(v, (JaxConfig, port_config.Config)) else v


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_mirrors_file(name):
    """Each port config equals ``configs/<name>.py`` field for field (the
    schedule dicts keyed by np.inf included); the flow classes are each
    package's RAFTFlow, the trackers each package's MFT; a weights path
    names the same file (the port's found from the package, not the
    working directory), and a default flow config's missing checkpoint
    leaves both on random weights."""
    jc = load_config(REPO / "configs" / f"{name}.py")
    pc = getattr(port_config, CONFIGS[name])()
    for key in TRACKER_KEYS:
        assert _value(getattr(pc, key)) == _value(getattr(jc, key)), key
    for key in FLOW_KEYS:
        assert _value(getattr(pc.flow_config, key)) == _value(getattr(jc.flow_config, key)), key
    assert pc.flow_config.of_class is RAFTFlow
    assert pc.tracker_class.__module__ == "mft_tpu_torch.tracker.mft"
    jm, pm = jc.flow_config.model, pc.flow_config.model
    if jm and Path(jm).exists():
        assert Path(pm).resolve() == Path(jm).resolve() == WEIGHTS
    else:
        assert not pm or not (REPO / pm).exists()
