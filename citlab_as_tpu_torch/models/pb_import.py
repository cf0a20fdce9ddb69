"""Frozen-graph (.pb) weight importer, no TensorFlow (port of
``citlab_as_tpu/models/pb_import.py``).

The reference ships its nets as frozen TF1 GraphDefs (stripped from this
checkout, nets/README.md); where such files are present their Const weights
import into the port's ARU-Net. This module hand-parses the protobuf wire
format (GraphDef -> NodeDef -> AttrValue -> TensorProto), enough to extract
every Const tensor by name, and maps the TF variable scopes
(aru_net/featMapG/unet_down_i/convR_j/weights, ARU_v1.py's scope layout)
onto flat flax paths; ``weights.py::arunet_state_dict_from_flax`` then
maps those onto the port's ``ARUNet``:

    flat = weights.arunet_flax_from_state_dict(model.state_dict())
    flat, matched, unmatched = import_arunet_weights("net.pb", flat)
    model.load_state_dict(weights.arunet_state_dict_from_flax(flat))
"""
from __future__ import annotations

import logging
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# TF DataType enum -> numpy dtype
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
           6: np.int8, 9: np.int64, 10: np.bool_, 19: np.float16}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    """Generic wire-format walk: {field_number: [(wire_type, raw_value)]}.
    Length-delimited values stay bytes; varints stay ints; fixed32/64 stay
    raw 4/8-byte strings."""
    out: Dict[int, List[Tuple[int, Any]]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field = tag >> 3
        wire = tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"Unsupported wire type {wire} at {pos}")
        out.setdefault(field, []).append((wire, value))
    return out


def _first_bytes(msg, field) -> Optional[bytes]:
    vals = msg.get(field)
    return vals[0][1] if vals else None


def _parse_tensor_proto(buf: bytes) -> Optional[np.ndarray]:
    """TensorProto: 1 dtype, 2 tensor_shape{2: Dim{1: size}}, 4
    tensor_content, 5.. typed value lists."""
    msg = parse_message(buf)
    dtype_field = msg.get(1)
    if not dtype_field:
        return None
    np_dtype = _DTYPES.get(dtype_field[0][1])
    if np_dtype is None:
        return None

    shape = []
    shape_buf = _first_bytes(msg, 2)
    if shape_buf is not None:
        shape_msg = parse_message(shape_buf)
        for _, dim_buf in shape_msg.get(2, []):
            dim_msg = parse_message(dim_buf)
            size = dim_msg.get(1, [(0, 0)])[0][1]
            shape.append(int(size))

    content = _first_bytes(msg, 4)
    if content:
        arr = np.frombuffer(content, dtype=np_dtype)
        return arr.reshape(shape) if shape else arr

    # fall back to typed value lists (scalar / small consts)
    if np_dtype == np.float32 and 6 in msg:
        vals = []
        for wire, v in msg[6]:
            if wire == 5:
                vals.append(struct.unpack("<f", v)[0])
            elif wire == 2:  # packed
                vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
        return np.asarray(vals, np.float32).reshape(shape) if shape else \
            np.asarray(vals, np.float32)
    if np_dtype in (np.int32, np.int64):
        field = 7 if np_dtype == np.int32 else 10
        vals = []
        for wire, v in msg.get(field, []):
            if wire == 0:
                vals.append(v)
            elif wire == 2:
                pos = 0
                while pos < len(v):
                    val, pos = _read_varint(v, pos)
                    vals.append(val)
        return np.asarray(vals, np_dtype).reshape(shape) if shape else \
            np.asarray(vals, np_dtype)
    return None


def load_pb_constants(path_or_bytes) -> Dict[str, np.ndarray]:
    """Extract {node_name: tensor} for every Const node of a GraphDef."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    graph = parse_message(buf)
    constants: Dict[str, np.ndarray] = {}
    for _, node_buf in graph.get(1, []):  # GraphDef.node
        node = parse_message(node_buf)
        name = _first_bytes(node, 1)
        op = _first_bytes(node, 2)
        if op is None or op.decode() != "Const" or name is None:
            continue
        for _, attr_buf in node.get(5, []):  # NodeDef.attr entries
            attr = parse_message(attr_buf)
            key = _first_bytes(attr, 1)
            if key is None or key.decode() != "value":
                continue
            value_buf = _first_bytes(attr, 2)
            if value_buf is None:
                continue
            attr_value = parse_message(value_buf)
            tensor_buf = _first_bytes(attr_value, 8)  # AttrValue.tensor
            if tensor_buf is None:
                continue
            tensor = _parse_tensor_proto(tensor_buf)
            if tensor is not None:
                constants[name.decode()] = tensor
    return constants


# ---------------------------------------------------------------- mapping

def _tf_to_flax_name(tf_name: str) -> Optional[str]:
    """Map the ARU_v1.py TF scope layout onto the flax ARUNet tree.

    TF:   aru_net/featMapG/unet_down_0/conv1/weights
    flax: params/featMapG/unet_down_0/conv1/conv/kernel
    Deconvs: unet_up_i/deconv/weights -> unet_up_i_deconv/deconv/kernel.
    Attention: attMapG/attPart/convK/... Logits: logit/class/...
    """
    name = tf_name
    name = re.sub(r"^aru_net/", "", name)
    name = re.sub(r"/read$", "", name)

    m = re.match(r"featMapG/(unet_(?:down|up)_\d+)/deconv/(weights|bias)$", name)
    if m:
        leaf = "kernel" if m.group(2) == "weights" else "bias"
        return f"params/featMapG/{m.group(1)}_deconv/deconv/{leaf}"
    m = re.match(r"featMapG/(unet_(?:down|up)_\d+)/(conv1|convR_\d+)/(weights|biases)$", name)
    if m:
        leaf = "kernel" if m.group(3) == "weights" else "bias"
        return f"params/featMapG/{m.group(1)}/{m.group(2)}/conv/{leaf}"
    m = re.match(r"attMapG/attPart/(conv\d)/(weights|biases)$", name)
    if m:
        leaf = "kernel" if m.group(2) == "weights" else "bias"
        return f"params/attMapG/{m.group(1)}/conv/{leaf}"
    m = re.match(r"logit/class/(weights|biases)$", name)
    if m:
        leaf = "kernel" if m.group(1) == "weights" else "bias"
        return f"params/logit/conv/{leaf}"
    return None


def import_arunet_weights(pb_path, variables: Dict[str, np.ndarray],
                          strict: bool = True
                          ) -> Tuple[Dict[str, np.ndarray], List[str], List[str]]:
    """Load Const weights from a frozen ARU-Net .pb into flat flax
    ``variables`` (``{"params/featMapG/...": array}``).

    Returns (new variables, matched flax paths, unmatched tf names). Leaves
    without a matching Const keep their values. A TF const that maps onto
    an ARU parameter but mismatches its shape means a broken import (the
    net would silently run with random weights): with ``strict`` it raises
    instead of being skipped."""
    constants = load_pb_constants(pb_path)
    mapped: Dict[str, np.ndarray] = {}
    unmatched: List[str] = []
    for tf_name, tensor in constants.items():
        flax_name = _tf_to_flax_name(tf_name)
        if flax_name is None:
            unmatched.append(tf_name)
            continue
        if flax_name.endswith("deconv/kernel") and tensor.ndim == 4:
            # tf.nn.conv2d_transpose kernels are [k, k, out_ch, in_ch] with
            # gradient-of-conv semantics (== lax.conv_transpose
            # transpose_kernel=True); flax ConvTranspose uses
            # transpose_kernel=False with [k, k, in_ch, out_ch] and no
            # spatial flip, so flip h/w and swap the channel axes
            tensor = tensor[::-1, ::-1].transpose(0, 1, 3, 2)
        if flax_name in variables and np.shape(variables[flax_name]) == tensor.shape:
            mapped[flax_name] = tensor
        elif strict:
            want = (np.shape(variables[flax_name])
                    if flax_name in variables else "<param absent>")
            raise ValueError(
                f"pb import: const {tf_name} maps to {flax_name} but shapes "
                f"disagree (pb {tensor.shape} vs flax {want}) — the model "
                f"config does not match the frozen graph")
        else:
            unmatched.append(tf_name)

    new: Dict[str, np.ndarray] = {}
    matched: List[str] = []
    # leaves in the order jax.tree_util walks the nested variables
    for name in sorted(variables, key=lambda p: p.split("/")):
        leaf = variables[name]
        if name in mapped:
            new[name] = np.asarray(mapped[name], dtype=np.asarray(leaf).dtype)
            matched.append(name)
        else:
            new[name] = leaf
    logger.info("pb import: matched %d params, %d unmatched consts",
                len(matched), len(unmatched))
    return new, matched, unmatched
