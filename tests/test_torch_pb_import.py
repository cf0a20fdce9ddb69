"""The port's frozen-graph (.pb) importer against the JAX package's, on the
CPU, with GraphDef wire bytes encoded here (no TensorFlow): every scope of
an ARU-Net (detCNN convs and residual convs, transposed convs, the
attention net, the logits) as Const nodes in TF's layouts, beside consts
that map to nothing. The port's import equals the JAX import bit for bit,
the transposed convs' flip and channel swap included; a const whose shape
disagrees raises the same error in both; the imported weights run the
port's ARU-Net as flax runs the JAX one.
"""
import re
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from citlab_as_tpu.models import pb_import as jpb
from citlab_as_tpu.models.arunet import ARUNet as JARUNet
from citlab_as_tpu_torch.models import pb_import as tpb
from citlab_as_tpu_torch.models.arunet import ARUNet
from citlab_as_tpu_torch.weights import arunet_flax_from_state_dict, arunet_state_dict_from_flax

GRAPH = {"featRoot": 8, "scale_space_num": 3, "res_depth": 2, "num_scales_att": 2}


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2, _varint(len(payload)) + payload)


def _tensor_proto(arr: np.ndarray, packed_values: bool = False) -> bytes:
    """TensorProto: dtype, shape, then the bytes (``tensor_content``) or,
    for small float consts, the packed ``float_val`` list."""
    dtype = {np.dtype(np.float32): 1, np.dtype(np.int32): 3}[arr.dtype]
    out = _field(1, 0, _varint(dtype))
    shape = b"".join(_len_field(2, _field(1, 0, _varint(d))) for d in arr.shape)
    out += _len_field(2, shape)
    if packed_values:
        out += _len_field(6, struct.pack(f"<{arr.size}f", *arr.ravel()))
    else:
        out += _len_field(4, arr.tobytes())
    return out


def _node(name: str, op: str, arr=None, packed_values=False) -> bytes:
    node = _len_field(1, name.encode()) + _len_field(2, op.encode())
    if arr is not None:
        attr_value = _len_field(8, _tensor_proto(arr, packed_values))
        node += _len_field(5, _len_field(1, b"value") + _len_field(2, attr_value))
    return _len_field(1, node)                      # GraphDef.node


def _flax_to_tf(path: str) -> str:
    """The TF const name ``_tf_to_flax_name`` maps onto ``path``."""
    p = path[len("params/"):]
    m = re.match(r"featMapG/(unet_(?:down|up)_\d+)_deconv/deconv/(kernel|bias)$", p)
    if m:
        return f"aru_net/featMapG/{m.group(1)}/deconv/" + \
            ("weights" if m.group(2) == "kernel" else "bias")
    leaf = "weights" if p.endswith("kernel") else "biases"
    m = re.match(r"featMapG/(unet_\w+_\d+)/(conv1|convR_\d+)/conv/", p)
    if m:
        return f"aru_net/featMapG/{m.group(1)}/{m.group(2)}/{leaf}"
    m = re.match(r"attMapG/(conv\d)/conv/", p)
    if m:
        return f"aru_net/attMapG/attPart/{m.group(1)}/{leaf}"
    assert p.startswith("logit/conv/"), path
    return f"aru_net/logit/class/{leaf}"


@pytest.fixture(scope="module")
def frozen_graph():
    """(GraphDef bytes, the flat flax weights it holds, a flat init to
    import into): every ARU parameter as a TF const, transposed-conv
    kernels in TF's [k, k, out, in] flipped layout; the logit bias as a
    packed ``float_val`` list; plus ``/read`` aliases and unrelated nodes."""
    rng = np.random.RandomState(0)
    init = arunet_flax_from_state_dict(ARUNet(graph_params=GRAPH).init_random(1).state_dict())
    weights = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
    graph = _node("inImg", "Placeholder")
    for path, arr in sorted(weights.items()):
        tf = arr[::-1, ::-1].transpose(0, 1, 3, 2) if path.endswith("deconv/kernel") else arr
        graph += _node(_flax_to_tf(path), "Const", np.ascontiguousarray(tf),
                       packed_values=path == "params/logit/conv/bias")
    graph += _node("aru_net/featMapG/unet_down_0/conv1/weights/read", "Identity")
    graph += _node("aru_net/shape_const", "Const", np.asarray([1, 2, 3], np.int32))
    graph += _node("some/unrelated/scale", "Const", np.ones(4, np.float32))
    return graph, weights, init


def test_parse_message_and_constants_equal_jax(frozen_graph):
    graph, weights, _ = frozen_graph
    assert tpb.parse_message(graph).keys() == jpb.parse_message(graph).keys()
    got, want = tpb.load_pb_constants(graph), jpb.load_pb_constants(graph)
    assert list(got) == list(want) and len(got) == len(weights) + 2
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for path in weights:
        assert tpb._tf_to_flax_name(_flax_to_tf(path)) == path
        assert jpb._tf_to_flax_name(_flax_to_tf(path)) == path


def test_import_equals_jax_bit_for_bit(frozen_graph, tmp_path):
    graph, weights, init = frozen_graph
    pb = tmp_path / "aru.pb"
    pb.write_bytes(graph)
    got, matched, unmatched = tpb.import_arunet_weights(str(pb), init)
    jvars = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                          for k, v in init.items()})
    jgot, jmatched, junmatched = jpb.import_arunet_weights(str(pb), jvars)
    jflat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(jgot, sep="/").items()}
    assert matched == jmatched and sorted(unmatched) == sorted(junmatched)
    assert sorted(unmatched) == ["aru_net/shape_const", "some/unrelated/scale"]
    assert set(matched) == set(weights) and set(got) == set(jflat)
    for k, v in jflat.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(got[k], weights[k], err_msg=k)   # flip undone
    assert any(k.endswith("deconv/kernel") for k in matched)


def test_imported_weights_run_the_port_arunet(frozen_graph):
    _, weights, init = frozen_graph
    flat, _, _ = tpb.import_arunet_weights(
        b"".join(_node(_flax_to_tf(p), "Const", np.ascontiguousarray(
            a[::-1, ::-1].transpose(0, 1, 3, 2) if p.endswith("deconv/kernel") else a))
            for p, a in weights.items()), init)
    x = np.random.RandomState(1).rand(1, 40, 48, 1).astype(np.float32)
    model = ARUNet(graph_params=GRAPH)
    model.load_state_dict(arunet_state_dict_from_flax(flat))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    jflat = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                          for k, v in weights.items()})
    want = np.asarray(JARUNet(graph_params=GRAPH).apply(jflat, jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_shape_mismatch_raises_in_both(frozen_graph):
    _, _, init = frozen_graph
    bad = _node("aru_net/featMapG/unet_down_1/conv1/weights", "Const",
                np.zeros((3, 3, 2, 2), np.float32))
    jvars = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                          for k, v in init.items()})
    with pytest.raises(ValueError) as got:
        tpb.import_arunet_weights(bad, init)
    with pytest.raises(ValueError) as want:
        jpb.import_arunet_weights(bad, jvars)
    assert str(got.value) == str(want.value) and "shapes disagree" in str(got.value)
    absent = _node("aru_net/featMapG/unet_down_9/conv1/weights", "Const",
                   np.zeros((3, 3, 8, 8), np.float32))
    with pytest.raises(ValueError, match="param absent"):
        tpb.import_arunet_weights(absent, init)
    flat, matched, unmatched = tpb.import_arunet_weights(bad + absent, init, strict=False)
    assert matched == [] and len(unmatched) == 2
    assert all(np.array_equal(flat[k], v) for k, v in init.items())
