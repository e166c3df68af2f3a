"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
JAX package's: round trips, escaped and legacy keys, the manifest's
msgpack codec against ``msgpack`` itself, and checkpoints of f32 params
plus AdamW state written by one package and loaded by the other."""
import os

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro import models as jmodels
from repro.configs import get_config as jax_get_config
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch.bridge import (
    opt_state_from_numpy,
    params_from_numpy,
)
from repro_torch.configs import get_config
from repro_torch.models import init_model
from repro_torch.train import checkpoint as tck
from repro_torch.train.optimizer import AdamWState, init_adamw
from repro_torch.utils.treeutil import tree_paths

torch.set_num_threads(1)


def _tiny(get):
    return get("yi-9b").reduced().replace(
        vocab_size=32, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128)


def _np_leaves(tree):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in tree_paths(tree).items()}


def _same(a, b):
    fa, fb = _np_leaves(a), _np_leaves(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _port_state(seed=0):
    params = init_model(torch.Generator().manual_seed(seed),
                        _tiny(get_config), torch.float32, "cpu")
    opt = init_adamw(params)
    rng = np.random.default_rng(seed)
    # moments and a step that are not the initial zeros
    for t in (*tree_paths(opt.mu).values(), *tree_paths(opt.nu).values()):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape)
                                 .astype(np.float32)).abs())
    return {"params": params, "opt": opt._replace(step=5)}


def test_checkpoint_roundtrip(tmp_path):
    state = _port_state()
    tck.save_checkpoint(str(tmp_path / "ck"), state, step=7,
                        metadata={"arch": "yi-9b"})
    assert tck.checkpoint_exists(str(tmp_path / "ck"))
    got, step, meta = tck.load_checkpoint(str(tmp_path / "ck"), state)
    assert step == 7 and meta == {"arch": "yi-9b"}
    assert isinstance(got["opt"], AdamWState)
    assert got["opt"].step == 5 and isinstance(got["opt"].step, int)
    _same(got, state)


def test_checkpoint_roundtrip_adversarial_keys(tmp_path):
    """JAX's adversarial keys (tests/test_train.py): literal '|', the
    escape char '~', and escape-like runs, as numpy and as tensor
    leaves."""
    tree = {
        "plain": np.arange(3, dtype=np.float32),
        "pipe|separated": np.ones(2, np.float32),
        "ti~lde": np.zeros(2, np.float32),
        "tricky~1combo": np.full(2, 7.0, np.float32),
        "even~0|~1worse": np.full(2, -1.0, np.float32),
        "nested": {"a|b": np.arange(4, dtype=np.int32),
                   "t~1|": torch.arange(5, dtype=torch.float32)},
    }
    tck.save_checkpoint(str(tmp_path / "ck"), tree, step=1)
    got, step, _ = tck.load_checkpoint(str(tmp_path / "ck"), tree)
    assert step == 1
    _same(got, tree)
    # and the JAX package reads the same file into the same values
    jgot, jstep, _ = jck.load_checkpoint(
        str(tmp_path / "ck"),
        {**tree, "nested": {**tree["nested"],
                            "t~1|": np.zeros(5, np.float32)}})
    assert jstep == 1
    np.testing.assert_array_equal(np.asarray(jgot["nested"]["t~1|"]),
                                  np.arange(5, dtype=np.float32))
    for k in ("plain", "pipe|separated", "ti~lde", "tricky~1combo",
              "even~0|~1worse"):
        np.testing.assert_array_equal(np.asarray(jgot[k]), tree[k])


@pytest.mark.parametrize("key", ["~01", "~1", "a~b/c"])
def test_escape_round_trips_like_the_jax_package(key):
    assert tck._escape_key(key) == jck._escape_key(key)
    assert tck._unescape_key(tck._escape_key(key)) == key


def test_checkpoint_loads_legacy_pipe_escaped_arrays(tmp_path):
    """Checkpoints written by the old '|' scheme (no '|' in keys) load
    through the manifest-driven fallback."""
    tree = {"layer": {"w": torch.arange(4, dtype=torch.float32)}}
    path = str(tmp_path / "legacy")
    os.makedirs(path)
    np.savez(os.path.join(path, "arrays.npz"),
             **{"/layer/w".replace("/", "|"): np.arange(4, dtype=np.float32)})
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb({"step": 3, "keys": ["/layer/w"],
                               "metadata": {}}))
    got, step, _ = tck.load_checkpoint(path, tree)
    assert step == 3
    assert torch.equal(got["layer"]["w"], tree["layer"]["w"])


def test_missing_array_raises_naming_the_key(tmp_path):
    tck.save_checkpoint(str(tmp_path / "ck"), {"a": np.ones(2)}, step=0)
    with open(tmp_path / "ck" / "manifest.msgpack", "wb") as f:
        f.write(msgpack.packb({"step": 0, "keys": ["/a", "/b"],
                               "metadata": {}}))
    with pytest.raises(KeyError, match="'/b'"):
        tck.load_checkpoint(str(tmp_path / "ck"),
                            {"a": np.ones(2), "b": np.ones(2)})


# ---------------------------------------------------------------------------
# the manifest codec against msgpack 1.x
# ---------------------------------------------------------------------------
_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary())
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=8), inner,
                                     max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_manifest_codec_matches_msgpack(obj):
    data = msgpack.packb(obj)
    assert tck.packb(obj) == data
    assert tck.unpackb(data) == msgpack.unpackb(data)


@pytest.mark.parametrize("n", [0, 15, 16, 255, 256, 65535, 65536])
def test_manifest_codec_length_boundaries(n):
    for obj in ("x" * n, b"x" * n, [0] * n, {str(i): i for i in range(n)}):
        assert tck.packb(obj) == msgpack.packb(obj)
        assert tck.unpackb(msgpack.packb(obj)) == msgpack.unpackb(
            msgpack.packb(obj))


def test_manifest_codec_reads_what_msgpack_writes_only():
    # float32 (msgpack's use_single_float) reads; a stray byte does not
    assert tck.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(ValueError, match="extra"):
        tck.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="ends early"):
        tck.unpackb(msgpack.packb("abc")[:-1])
    with pytest.raises(TypeError):
        tck.packb(object())


def test_manifest_bytes_equal_msgpack(tmp_path):
    state = _port_state()
    tck.save_checkpoint(str(tmp_path / "ck"), state, step=3,
                        metadata={"workflow": "GRPORunner"})
    raw = (tmp_path / "ck" / "manifest.msgpack").read_bytes()
    manifest = {"step": 3, "keys": list(tree_paths(state)),
                "metadata": {"workflow": "GRPORunner"}}
    assert raw == msgpack.packb(manifest)


# ---------------------------------------------------------------------------
# cross-loading: f32 params + AdamW of a reduced yi-9b
# ---------------------------------------------------------------------------
def _jax_state():
    cfg = _tiny(jax_get_config)
    params = jmodels.init_model(jax.random.PRNGKey(3), cfg)
    opt = jopt.init_adamw(params)
    leaves, tdef = jax.tree_util.tree_flatten(opt.mu)
    rng = np.random.default_rng(3)
    mu = jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(rng.standard_normal(l.shape), jnp.float32)
               for l in leaves])
    nu = jax.tree.map(jnp.abs, mu)
    opt = opt._replace(step=jnp.asarray(4, jnp.int32), mu=mu, nu=nu)
    return {"params": params, "opt": opt}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jstate = _jax_state()
    jck.save_checkpoint(str(tmp_path / "ck"), jstate, step=2,
                        metadata={"workflow": "GRPORunner"})
    template = {"params": params_from_numpy(_np(jstate["params"]),
                                            device="cpu"),
                "opt": opt_state_from_numpy(_np(jstate["opt"]),
                                            device="cpu")}
    for t in tree_paths(template).values():
        if isinstance(t, torch.Tensor):
            t.zero_()
    got, step, meta = tck.load_checkpoint(str(tmp_path / "ck"), template)
    assert step == 2 and meta == {"workflow": "GRPORunner"}
    assert got["opt"].step == 4 and isinstance(got["opt"].step, int)
    want = _np_leaves(_np(jstate))
    have = _np_leaves(got)
    assert want.keys() == have.keys()
    for k in want:
        if not k.endswith("step"):  # an int in the port, checked above
            assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_port_checkpoint_loads_into_jax(tmp_path):
    state = _port_state(seed=1)
    tck.save_checkpoint(str(tmp_path / "ck"), state, step=9)
    template = _jax_state()
    got, step, _ = jck.load_checkpoint(str(tmp_path / "ck"), template)
    assert step == 9
    # JAX's step comes back as the 0-d int32 array JAX itself writes
    assert np.asarray(got["opt"].step).dtype == np.int32
    assert int(got["opt"].step) == 5
    want = _np_leaves(state)
    have = _np_leaves(_np(got))
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# bf16 leaves: two bytes a value, as np.savez stores ml_dtypes' bf16
# ---------------------------------------------------------------------------
def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn((3, 5), generator=g).to(torch.bfloat16)
    tck.save_checkpoint(str(tmp_path / "ck"), {"w": w}, step=0)
    with np.load(tmp_path / "ck" / "arrays.npz") as z:
        assert z["~1w"].dtype == np.dtype("V2")
    got, _, _ = tck.load_checkpoint(str(tmp_path / "ck"),
                                    {"w": torch.zeros_like(w)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))


def test_jax_bf16_checkpoint_loads_into_the_port_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    jw = jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)
    jck.save_checkpoint(str(tmp_path / "ck"), {"w": jw}, step=0)
    got, _, _ = tck.load_checkpoint(
        str(tmp_path / "ck"), {"w": torch.zeros((4, 6), dtype=torch.bfloat16)})
    bits = np.asarray(jw).view(np.int16)
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(), bits)


def test_jax_package_refuses_its_own_bf16_checkpoints(tmp_path):
    """An observation about the reference, pinned: np.savez stores bf16
    as |V2 and the JAX package's load_checkpoint then refuses it (the
    port reads the bits back by its template; ROADMAP.md section 3)."""
    jw = jnp.ones((2, 2), jnp.bfloat16)
    jck.save_checkpoint(str(tmp_path / "ck"), {"w": jw}, step=0)
    with pytest.raises(TypeError, match="V2"):
        jck.load_checkpoint(str(tmp_path / "ck"), {"w": jw})


# ---------------------------------------------------------------------------
# the npz reader: CRC-checked, and numpy's own reader for what it does not
# read itself
# ---------------------------------------------------------------------------
def test_npz_reader_checks_crc(tmp_path):
    tree = {"w": torch.arange(4096, dtype=torch.float32)}
    tck.save_checkpoint(str(tmp_path / "ck"), tree, step=0)
    npz = tmp_path / "ck" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    at = raw.index(np.arange(4096, dtype=np.float32)[100:102].tobytes())
    raw[at] ^= 0xFF  # one flipped bit pattern inside the array's data
    npz.write_bytes(bytes(raw))
    import zipfile
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        tck.load_checkpoint(str(tmp_path / "ck"), tree)
    with pytest.raises(zipfile.BadZipFile, match="CRC"):  # as np.load does
        with np.load(npz) as z:
            z["~1w"]


def test_npz_reader_reads_compressed_and_fortran_members(tmp_path):
    path = str(tmp_path / "ck")
    os.makedirs(path)
    a = np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4))
    b = np.arange(5, dtype=np.int64)
    np.savez(os.path.join(path, "arrays.npz"), **{"~1a": a})
    got = tck._read_npz(os.path.join(path, "arrays.npz"))
    np.testing.assert_array_equal(got["~1a"], a)
    np.savez_compressed(os.path.join(path, "arrays.npz"), **{"~1b": b})
    got = tck._read_npz(os.path.join(path, "arrays.npz"))
    np.testing.assert_array_equal(got["~1b"], b)
