"""A read-only OCDBT store: tensorstore's "optionally-cooperative distributed
b+tree" key-value format, which orbax writes every checkpoint into (one
store per checkpoint directory: ``manifest.ocdbt``, ``d/`` and, per writing
process, ``ocdbt.process_<n>/`` whose data files the root's b-tree
references by path).

The format, as tensorstore 0.1 writes it (its ``ocdbt.dump`` shows the same
fields):

- A manifest or b-tree node is framed: a magic number (``0x0cdb3a2a`` for a
  manifest, ``0x0cdb20de`` for a node, big-endian), its length in bytes
  (u64 little-endian), a format version (varint, 0), a compression
  (varint: 0 none, 1 zstd), the body, and a CRC-32C (u32 little-endian) of
  every byte before it.
- The manifest body: the config (uuid, manifest kind, the largest inline
  value, the largest decoded node, the version tree's arity (log2), the
  compression and, for zstd, its level), then the version tree: a data
  file table, the newest versions inline (generation, root height, root
  node reference, key / tree-byte / indirect-byte counts, commit time, each
  a column) and references to version-tree nodes holding older ones.
- A data file table: the file count and, per file, the length of the prefix
  it shares with the previous path, its suffix length and its base path's
  length, then the suffixes; a file lies at ``base path + relative path``
  under the store's directory.
- A b-tree node body: its height, a data file table, the entry count, the
  keys (prefix lengths shared with the previous key, suffix lengths and,
  in an interior node, each subtree's common prefix length, then the
  suffixes), then per leaf entry the value's length, kind (0 inline, 1 in a
  data file), the file and offset of each stored value and the inline
  bytes; per interior entry the child's file, offset and length and its
  key / tree-byte / indirect-byte counts. Keys below an interior entry are
  stored without the node's prefix and that entry's common prefix.

:class:`OcdbtStore` reads the newest version of a store (``list``,
``read``). A single-file manifest is read; a numbered manifest, another
format version or compression, a damaged frame (magic, length, checksum),
a malformed body, a data file outside the store or a value past its file's
end raise :class:`OcdbtError` naming the fault.

:class:`OcdbtWriter` writes a new store of one version in one level, as
tensorstore reads it: ``manifest.ocdbt`` (the config orbax gives its stores,
a fresh uuid) and one data file ``d/<32 hex digits>`` holding the values
longer than ``max_inline_value_bytes`` and then the b-tree, leaves cut so
that none decodes to more than ``max_decoded_node_bytes`` and interior
nodes above them. Orbax writes a second level beside it
(``ocdbt.process_<n>/``, each writing process's own store, which the root's
b-tree references by path), but its restore opens only the root store, so
one level holds all a restore reads.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from citlab_as_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
_COMPRESSIONS = {0: "none", 1: "zstd"}


class OcdbtError(ValueError):
    """The store is damaged, or in a variant of the format this reader does
    not read; the message names which."""


class Config(NamedTuple):
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: str
    zstd_level: Optional[int]


class Ref(NamedTuple):
    """Bytes ``[offset, offset + length)`` of a data file."""
    path: str
    offset: int
    length: int


class Version(NamedTuple):
    generation: int
    root_height: int
    root: Ref
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int


class VersionNode(NamedTuple):
    """A reference to a version-tree node (older versions)."""
    generation: int
    node: Ref
    num_generations: int
    commit_time: int
    height: int


class _Body:
    """Bounds-checked reads of a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.at, self.what = data, 0, what

    def fail(self, why: str):
        raise OcdbtError(f"{self.what}: {why}")

    def byte(self) -> int:
        if self.at >= len(self.data):
            self.fail("ends early")
        self.at += 1
        return self.data[self.at - 1]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            self.fail("ends early")
        self.at += n
        return self.data[self.at - n:self.at]

    def u64(self) -> int:
        return int.from_bytes(self.raw(8), "little")

    def done(self) -> None:
        if self.at != len(self.data):
            self.fail(f"{len(self.data) - self.at} bytes after its end")


def unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of a framed manifest or node, its frame checked."""
    if len(data) < 18:
        raise OcdbtError(f"{what}: {len(data)} bytes, too short for a frame")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:08x}, not {magic:08x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OcdbtError(f"{what}: frame says {length} bytes, holds {len(data)}")
    crc = int.from_bytes(data[-4:], "little")
    if zstd.crc32c(data[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Body(data[12:-4], what)
    version = head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} is not read (only 0)")
    compression = head.varint()
    payload = head.data[head.at:]
    if compression == 0:
        return payload
    if compression == 1:
        try:
            return zstd.decompress(payload)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from None
    raise OcdbtError(f"{what}: compression {compression} is not read (0 none, 1 zstd)")


def _file_table(body: _Body) -> List[str]:
    n = body.varint()
    prefix = [0] + body.varints(n - 1) if n else []
    suffix = body.varints(n)
    base = body.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            body.fail("data file path prefix past the previous path")
        path = prev[:prefix[i]] + body.raw(suffix[i])
        if base[i] > len(path):
            body.fail("base path longer than its path")
        prev = path
        try:
            paths.append(path.decode())
        except UnicodeDecodeError:
            body.fail("data file path is not UTF-8")
    return paths


def _refs(body: _Body, files: List[str], n: int, with_length: bool = True
          ) -> List[Tuple[str, int, int]]:
    ids = body.varints(n)
    offsets = body.varints(n)
    lengths = body.varints(n) if with_length else [0] * n
    out = []
    for i, o, ln in zip(ids, offsets, lengths):
        if i >= len(files):
            body.fail(f"data file {i} of {len(files)}")
        out.append((files[i], o, ln))
    return out


def _keys(body: _Body, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + body.varints(n - 1) if n else []
    suffix = body.varints(n)
    common = body.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            body.fail("key prefix past the previous key")
        key = prev[:prefix[i]] + body.raw(suffix[i])
        if keys and key <= keys[-1]:
            body.fail("keys out of order")
        if interior and common[i] > len(key):
            body.fail("subtree prefix past its key")
        keys.append(key)
        prev = key
    return keys, common


class OcdbtStore:
    """The newest version of the OCDBT store in directory ``path``.

    ``list()`` gives its keys in order, ``read(key)`` a value's bytes
    (``KeyError`` for a key it lacks); keys are ``str`` (UTF-8). The tree is
    read at the first of them and kept; data files are read once each."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        manifest_path = os.path.join(self.path, MANIFEST_FILE)
        if not os.path.isfile(manifest_path):
            raise FileNotFoundError(f"no OCDBT manifest: {manifest_path}")
        with open(manifest_path, "rb") as f:
            raw = f.read()
        body = _Body(unframe(raw, MANIFEST_MAGIC, manifest_path), manifest_path)
        uuid = body.raw(16)
        kind = body.varint()
        max_inline = body.varint()
        max_node = body.varint()
        arity = body.byte()
        comp = body.varint()
        if comp not in _COMPRESSIONS:
            body.fail(f"node compression {comp} is not read (0 none, 1 zstd)")
        level = int.from_bytes(body.raw(4), "little", signed=True) if comp == 1 else None
        self.config = Config(uuid, kind, max_inline, max_node, arity,
                             _COMPRESSIONS[comp], level)
        if kind != 0:
            body.fail(f"manifest kind {kind} (numbered manifests) is not read, "
                      "only a single-file manifest")
        files = _file_table(body)
        n = body.varint()
        gens = body.varints(n)
        heights = [body.byte() for _ in range(n)]
        roots = _refs(body, files, n)
        counts = [body.varints(n) for _ in range(3)]
        times = [body.u64() for _ in range(n)]
        self.versions = [
            Version(g, h, Ref(*r), k, t, iv, c)
            for g, h, r, k, t, iv, c in zip(gens, heights, roots, *counts, times)]
        m = body.varint()
        node_gens = body.varints(m)
        node_refs = _refs(body, files, m)
        node_counts = body.varints(m)
        node_times = [body.u64() for _ in range(m)]
        node_heights = [body.byte() for _ in range(m)]
        body.done()
        self.version_nodes = [VersionNode(g, Ref(*r), c, t, h) for g, r, c, t, h in
                              zip(node_gens, node_refs, node_counts, node_times,
                                  node_heights)]
        if not self.versions:
            body.fail("no version")
        for a, b in zip(self.versions, self.versions[1:]):
            if b.generation <= a.generation:
                body.fail("versions out of order")
        self.version = self.versions[-1]
        self._files: Dict[str, bytes] = {}
        self._index: Optional[Dict[bytes, object]] = None

    # ------------------------------------------------------------ files
    def _file(self, rel: str) -> bytes:
        data = self._files.get(rel)
        if data is None:
            parts = rel.split("/")
            if rel.startswith("/") or any(p in ("", ".", "..") for p in parts):
                raise OcdbtError(f"{self.path}: data file {rel!r} outside the store")
            with open(os.path.join(self.path, *parts), "rb") as f:
                data = f.read()
            self._files[rel] = data
        return data

    def _bytes(self, ref: Ref) -> bytes:
        data = self._file(ref.path)
        if ref.offset + ref.length > len(data):
            raise OcdbtError(f"{self.path}: {ref.path} bytes [{ref.offset}, "
                             f"{ref.offset + ref.length}) past its {len(data)} bytes")
        return data[ref.offset:ref.offset + ref.length]

    # ------------------------------------------------------------ tree
    def _node(self, ref: Ref, height: int, prefix: bytes, out: Dict[bytes, object]) -> int:
        what = f"{self.path}: node {ref.path}@{ref.offset}"
        data = unframe(self._bytes(ref), NODE_MAGIC, what)
        if len(data) > self.config.max_decoded_node_bytes:
            raise OcdbtError(f"{what}: {len(data)} bytes past the config's "
                             f"{self.config.max_decoded_node_bytes}")
        body = _Body(data, what)
        got = body.byte()
        if got != height:
            body.fail(f"height {got}, its parent says {height}")
        files = _file_table(body)
        n = body.varint()
        if n == 0:
            body.fail("no entries")
        keys, common = _keys(body, n, interior=height > 0)
        if height == 0:
            lengths = body.varints(n)
            kinds = body.varints(n)
            if any(k > 1 for k in kinds):
                body.fail(f"value kind {max(kinds)} (0 inline, 1 indirect)")
            stored = _refs(body, files, sum(kinds), with_length=False)
            refs = iter(stored)
            for key, length, kind in zip(keys, lengths, kinds):
                if kind:
                    path, offset, _ = next(refs)
                    out[prefix + key] = Ref(path, offset, length)
                else:
                    out[prefix + key] = body.raw(length)
            body.done()
            return n
        children = _refs(body, files, n)
        num_keys = body.varints(n)
        body.varints(n)   # tree bytes
        body.varints(n)   # indirect value bytes
        body.done()
        total = 0
        for key, cp, child, want in zip(keys, common, children, num_keys):
            got_keys = self._node(Ref(*child), height - 1, prefix + key[:cp], out)
            if got_keys != want:
                raise OcdbtError(f"{what}: child holds {got_keys} keys, the node says {want}")
            total += got_keys
        return total

    def _tree(self) -> Dict[bytes, object]:
        if self._index is None:
            index: Dict[bytes, object] = {}
            v = self.version
            if v.num_keys:
                got = self._node(v.root, v.root_height, b"", index)
                if got != v.num_keys:
                    raise OcdbtError(f"{self.path}: tree holds {got} keys, the manifest "
                                     f"says {v.num_keys}")
            self._index = index
        return self._index

    def list(self) -> List[str]:
        return [k.decode() for k in sorted(self._tree())]

    def read(self, key: str) -> bytes:
        val = self._tree()[key.encode()]
        return self._bytes(val) if isinstance(val, Ref) else val

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._tree()


# ---------------------------------------------------------------- writing

#: orbax's store config (``add_ocdbt_write_options``, tensorstore's
#: defaults for the rest): values up to 1 KiB inline, one b-tree node up to
#: 100 MB decoded, version-tree arity 16, zstd at its default level
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
#: the most bytes one key's varints (lengths, file, offset) add to a node
_ENTRY_VARINTS = 60


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        low = value & 0x7F
        value >>= 7
        if not value:
            out.append(low)
            return bytes(out)
        out.append(low | 0x80)


def _varints(values: Sequence[int]) -> bytes:
    return b"".join(_varint(v) for v in values)


def _frame(body: bytes, magic: int) -> bytes:
    """A framed manifest or node: ``body`` zstd-compressed (the config's
    compression) between the magic, length and format version, and the
    CRC-32C."""
    payload = _varint(0) + _varint(1) + zstd.compress(body)
    head = magic.to_bytes(4, "big") + (12 + len(payload) + 4).to_bytes(8, "little")
    data = head + payload
    return data + zstd.crc32c(data).to_bytes(4, "little")


def _common(a: bytes, b: bytes) -> int:
    return len(os.path.commonprefix([a, b]))


def _file_table_bytes(paths: List[str]) -> bytes:
    raw = [p.encode() for p in paths]
    prefix = [_common(a, b) for a, b in zip(raw, raw[1:])]
    suffix = [len(p) - c for p, c in zip(raw, [0] + prefix)]
    return (_varint(len(raw)) + _varints(prefix) + _varints(suffix)
            + _varints([0] * len(raw))
            + b"".join(p[c:] for p, c in zip(raw, [0] + prefix)))


def _keys_bytes(keys: List[bytes], common: Optional[List[int]] = None) -> bytes:
    prefix = [_common(a, b) for a, b in zip(keys, keys[1:])]
    starts = [0] + prefix
    out = (_varint(len(keys)) + _varints(prefix)
           + _varints([len(k) - c for k, c in zip(keys, starts)]))
    if common is not None:
        out += _varints(common)
    return out + b"".join(k[c:] for k, c in zip(keys, starts))


class _Child(NamedTuple):
    """A written node, as its parent references it."""
    first: bytes          # its first key, whole
    last: bytes           # its last key, whole
    ref: Ref
    num_keys: int
    tree_bytes: int       # its bytes and its subtree's
    indirect_bytes: int


class OcdbtWriter:
    """A new OCDBT store of one version in directory ``path``: ``put(key,
    value)`` each key (``str``, UTF-8) once, then ``commit()`` writes the
    data file and the manifest. The directory must not hold a store yet.
    Nodes stay within orbax's ``MAX_DECODED_NODE_BYTES``, which the
    manifest's config records."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._values: Dict[bytes, bytes] = {}

    def put(self, key: str, value: bytes) -> None:
        k = key.encode()
        if k in self._values:
            raise OcdbtError(f"{self.path}: key {key!r} written twice")
        self._values[k] = bytes(value)

    def _pack(self, items: list, cost) -> List[list]:
        """``items`` cut into runs whose node bodies stay within the limit
        (``cost``: an item's most bytes in a node, its key whole)."""
        budget = MAX_DECODED_NODE_BYTES - 64
        runs, run, used = [], [], 0
        for item in items:
            c = cost(item)
            if run and used + c > budget:
                runs.append(run)
                run, used = [], 0
            if c > budget:
                raise OcdbtError(f"{self.path}: one key's entry of {c} bytes exceeds "
                                 f"the node limit {MAX_DECODED_NODE_BYTES}")
            run.append(item)
            used += c
        return runs + [run]

    def commit(self) -> None:
        if not self._values:
            raise OcdbtError(f"{self.path}: a store without keys is not written")
        if os.path.exists(os.path.join(self.path, MANIFEST_FILE)):
            raise OcdbtError(f"{self.path}: already holds a store")
        name = "d/" + os.urandom(16).hex()
        blob = bytearray()
        keys = sorted(self._values)
        stored: Dict[bytes, int] = {}
        for k in keys:
            v = self._values[k]
            if len(v) > MAX_INLINE_VALUE_BYTES:
                stored[k] = len(blob)
                blob += v

        def write_node(body: bytes) -> Ref:
            data = _frame(body, NODE_MAGIC)
            ref = Ref(name, len(blob), len(data))
            blob.extend(data)
            return ref

        def leaf_cost(k):
            v = self._values[k]
            return len(k) + _ENTRY_VARINTS + (0 if k in stored else len(v))

        children: List[_Child] = []
        for run in self._pack(keys, leaf_cost):
            # a leaf's keys are stored without the prefix they all share,
            # which its parent's entry carries
            cp = _common(run[0], run[-1]) if len(keys) > len(run) else 0
            indirect = [k for k in run if k in stored]
            body = (bytes([0]) + _file_table_bytes([name] if indirect else [])
                    + _keys_bytes([k[cp:] for k in run])
                    + _varints([len(self._values[k]) for k in run])
                    + _varints([int(k in stored) for k in run])
                    + _varints([0] * len(indirect)) + _varints([stored[k] for k in indirect])
                    + b"".join(self._values[k] for k in run if k not in stored))
            if len(body) > MAX_DECODED_NODE_BYTES:
                raise OcdbtError(f"{self.path}: a leaf of {len(body)} bytes")
            ref = write_node(body)
            children.append(_Child(run[0], run[-1], ref, len(run), ref.length,
                                   sum(len(self._values[k]) for k in indirect)))
        height = 0
        while len(children) > 1:
            height += 1
            level: List[_Child] = []
            cost = (lambda c: len(c.first) + 2 * _ENTRY_VARINTS)
            runs = self._pack(children, cost)
            for run in runs:
                # the node's own prefix (what its parent strips), then per
                # entry its subtree's common prefix beyond that
                node_cp = _common(run[0].first, run[-1].last) if len(runs) > 1 else 0
                body = (bytes([height]) + _file_table_bytes([name])
                        + _keys_bytes([c.first[node_cp:] for c in run],
                                      [_common(c.first, c.last) - node_cp for c in run])
                        + _varints([0] * len(run)) + _varints([c.ref.offset for c in run])
                        + _varints([c.ref.length for c in run])
                        + _varints([c.num_keys for c in run])
                        + _varints([c.tree_bytes for c in run])
                        + _varints([c.indirect_bytes for c in run]))
                if len(body) > MAX_DECODED_NODE_BYTES:
                    raise OcdbtError(f"{self.path}: an interior node of {len(body)} bytes")
                ref = write_node(body)
                level.append(_Child(run[0].first, run[-1].last, ref,
                                    sum(c.num_keys for c in run),
                                    ref.length + sum(c.tree_bytes for c in run),
                                    sum(c.indirect_bytes for c in run)))
            children = level
        root = children[0]
        os.makedirs(os.path.join(self.path, "d"), exist_ok=True)
        with open(os.path.join(self.path, *name.split("/")), "wb") as f:
            f.write(blob)
        body = (os.urandom(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
                + _varint(1) + (0).to_bytes(4, "little")
                + _file_table_bytes([name])
                + _varint(1) + _varint(1) + bytes([height])
                + _varint(0) + _varint(root.ref.offset) + _varint(root.ref.length)
                + _varint(root.num_keys) + _varint(root.tree_bytes) + _varint(root.indirect_bytes)
                + time.time_ns().to_bytes(8, "little")
                + _varint(0))
        with open(os.path.join(self.path, MANIFEST_FILE), "wb") as f:
            f.write(_frame(body, MANIFEST_MAGIC))
