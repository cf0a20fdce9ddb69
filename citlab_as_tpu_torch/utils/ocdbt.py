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
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

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
