"""The port's reader of flax msgpack parameter files
(semantic_meshes_torch.models.serialization) against flax's writer and the
msgpack package, which the port does not use.

Every architecture's parameter tree, written by
`flax.serialization.to_bytes` (a bfloat16 leaf and a numpy scalar
included), reads back bit for bit; every msgpack type the subset holds
decodes as msgpack.unpackb decodes it; other ext codes and truncated
buffers raise. (`load_predictor(params_path=)` in both packages is
tests/test_torch_models.py's test_params_path_in_both_packages, beside the
trained weights it writes.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import msgpack
from flax import serialization as flax_serialization

from semantic_meshes.models import segmentation as jseg
from semantic_meshes_torch.models import serialization

CPU = "cpu"
ARCHS = {
    "unet": (jseg.UNet, (8, 16, 32), ((1, 32, 32, 3),)),
    "pspnet": (jseg.PSPNet, (8, 16, 32, 32), ((1, 64, 64, 3),)),
    "rgbd": (jseg.RGBDUNet, (8, 16, 32), ((1, 32, 32, 3), (1, 32, 32, 1))),
}


def _random_tree(arch, seed=0):
    """The flax parameter tree of `arch` (its structure from model.init
    traced, no compile), filled with seeded normal values."""
    cls, widths, shapes = ARCHS[arch]
    struct = jax.eval_shape(
        cls(classes=5, widths=widths).init, jax.random.PRNGKey(0),
        *(jnp.zeros(s, jnp.float32) for s in shapes))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0, 1, s.shape).astype(s.dtype), struct)


def _assert_same_tree(got, want):
    assert isinstance(got, dict) and set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_same_tree(got[key], value)
            continue
        assert torch.is_tensor(got[key]), key
        value = np.asarray(value)
        if value.dtype == jnp.bfloat16:
            assert got[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got[key].view(torch.int16).numpy(), value.view(np.int16))
        else:
            assert got[key].numpy().dtype == value.dtype, key
            np.testing.assert_array_equal(got[key].numpy(), value)
        assert tuple(got[key].shape) == value.shape


@pytest.mark.parametrize("arch", list(ARCHS))
def test_flax_bytes_read_back_bit_for_bit(arch):
    tree = _random_tree(arch)
    inner = tree["params"]
    # a bf16 leaf, a float64 and an int leaf, a numpy scalar (ext 3)
    first = sorted(inner)[0]
    inner[first] = dict(inner[first])
    inner[first]["bf16"] = np.asarray(
        jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16))
    inner["extra"] = {"f64": np.arange(5, dtype=np.float64) / 3,
                      "i32": np.arange(-4, 4, dtype=np.int32).reshape(2, 4),
                      "scalar": np.float32(2.5)}
    got = serialization.load_flax(flax_serialization.to_bytes(tree))
    scalar = got["params"]["extra"].pop("scalar")
    assert scalar.shape == () and scalar.dtype == torch.float32
    assert float(scalar) == 2.5
    inner["extra"].pop("scalar")
    _assert_same_tree(got, tree)


def test_msgpack_subset_decodes_as_msgpack_does():
    value = {
        "nil": None, "t": True, "f": False,
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                 -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é"],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "arrays": [list(range(15)), list(range(16)), list(range(70000))],
        "maps": [{str(i): i for i in range(15)},
                 {str(i): i for i in range(16)},
                 {str(i): i for i in range(70000)}],
        "nested": {"a": {"b": [1, {"c": None}]}},
    }
    for single in (False, True):
        data = msgpack.packb(value, use_bin_type=True,
                             use_single_float=single)
        assert serialization.load_flax(data) == msgpack.unpackb(data)


@pytest.mark.parametrize("code,size", [(2, 3), (5, 1), (7, 300), (127, 4)])
def test_other_ext_codes_raise(code, size):
    data = msgpack.packb({"x": msgpack.ExtType(code, b"\0" * size)})
    with pytest.raises(ValueError, match=f"ext type {code}"):
        serialization.load_flax(data)


def test_negative_ext_code_raises():
    # fixext 4 of type -1 (msgpack's timestamp), which msgpack.ExtType
    # refuses to build: {"x": ext(-1, 4 bytes)}
    data = b"\x81\xa1x\xd6\xff" + b"\0" * 4
    with pytest.raises(ValueError, match="ext type -1"):
        serialization.load_flax(data)


def test_truncated_and_trailing_bytes_raise():
    data = flax_serialization.to_bytes(
        {"params": {"w": np.ones((3, 4), np.float32)}})
    with pytest.raises(ValueError, match="truncated"):
        serialization.load_flax(data[:-5])
    with pytest.raises(ValueError, match="after the value"):
        serialization.load_flax(data + b"\xc0")
