"""The port's LMDB structure check (coclr_tpu_torch/data/lmdb_check.py)
against coclr_tpu/data/lmdb_check.py on the cases of
tests/test_lmdb_authentic.py: the hand-laid multi-commit and deep fixtures
(tests/lmdb_fixture.py), the LEAF2 and DUPSORT layouts, fuzzed output of the
port's writer, the nodemax boundary and corrupted files. On every file both
validators return the same summary, or both raise LMDBStructureError with
the same message."""

import struct

import numpy as np
import pytest

from coclr_tpu.data import lmdb_check as jax_check
from coclr_tpu_torch.data import lmdb_check as port_check
from coclr_tpu_torch.data.lmdb_format import write_lmdb

from lmdb_fixture import (
    F_DUPDATA,
    P_LEAF,
    P_LEAF2,
    assemble,
    deep_fixture,
    leaf_page,
    messy_fixture,
    meta_page,
)


def _outcome(module, path):
    """('ok', summary) or ('error', message) of one validator on path."""
    try:
        return "ok", module.validate_structure(path)
    except module.LMDBStructureError as e:
        return "error", str(e)


def _agree(path):
    got = _outcome(port_check, path)
    assert got == _outcome(jax_check, path)
    return got


def _single_leaf_file(path, psize, page, entries):
    pages = {0: meta_page(psize, 0, 0, root=2, depth=1, branch=0, leaf=1,
                          ovf=0, entries=entries, last_pg=2),
             1: meta_page(psize, 1, 1, root=2, depth=1, branch=0, leaf=1,
                          ovf=0, entries=entries, last_pg=2),
             2: page}
    return assemble(path, psize, pages, 3)


def _messy(tmp_path):
    return messy_fixture(str(tmp_path / "messy.lmdb"))[0]


def _deep(psize):
    return lambda tmp_path: deep_fixture(str(tmp_path / "deep.lmdb"), psize)[0]


def _leaf2(tmp_path):
    pg = leaf_page(4096, 2, [(b"k", b"v")], page_flags=P_LEAF | P_LEAF2)
    return _single_leaf_file(str(tmp_path / "leaf2.lmdb"), 4096, pg, 1)


def _dupsort(tmp_path):
    pg = leaf_page(4096, 2, [(b"k", b"subtree-bytes")],
                   node_flags={0: F_DUPDATA})
    return _single_leaf_file(str(tmp_path / "dup.lmdb"), 4096, pg, 1)


def _fuzzed(psize, trial):
    """test_writer_output_validates_fuzzed's draws: trial `trial` of the
    generator seeded with psize."""
    def build(tmp_path):
        rng = np.random.RandomState(psize)
        for _ in range(trial + 1):
            n = int(rng.randint(1, 400))
            items = {}
            for _ in range(n):
                klen = int(rng.randint(1, 60))
                key = bytes(rng.randint(32, 127, klen, dtype=np.uint8))
                vlen = int(rng.choice([0, 3, 50, 900, psize // 2,
                                       psize - 30, psize + 1, 3 * psize]))
                items[key] = bytes(rng.randint(0, 256, vlen, dtype=np.uint8))
        return write_lmdb(str(tmp_path / "fuzz.lmdb"), items.items(),
                          psize=psize)
    return build


def _nodemax(psize, over):
    """One value exactly at the inline limit 8 + k + v <= nodemax, or one
    byte over it."""
    def build(tmp_path):
        nm = ((psize - 16) // 2) & ~1
        key = b"key-x"
        items = {key: bytes(nm - 8 - len(key) + over)}
        return write_lmdb(str(tmp_path / "edge.lmdb"), items.items(),
                          psize=psize)
    return build


def _valid_items():
    return {b"%04d" % i: bytes([i % 256]) * 100 for i in range(300)}


def _corrupt(mutate):
    """test_validator_catches_corruption's valid file with `mutate(image,
    live_root)` applied; live_root is the live meta's root page."""
    def build(tmp_path):
        path = write_lmdb(str(tmp_path / "ok.lmdb"), _valid_items().items())
        with open(path, "rb") as f:
            img = bytearray(f.read())
        live_root = struct.unpack_from("<Q", img, 16 + 24 + 48 + 40)[0]
        mutate(img, live_root)
        bad = str(tmp_path / "bad.lmdb")
        with open(bad, "wb") as f:
            f.write(img)
        return bad
    return build


_META_MAIN = 16 + 24 + 48  # the main DB's MDB_db inside meta page 0

CASES = {
    "messy_multi_commit": _messy,
    **{f"deep_{p}": _deep(p) for p in (4096, 8192, 16384, 32768)},
    "leaf2_rejected": _leaf2,
    "dupsort_rejected": _dupsort,
    **{f"fuzzed_{p}_{t}": _fuzzed(p, t) for p in (4096, 8192, 32768)
       for t in range(3)},
    **{f"nodemax_{p}_{tag}": _nodemax(p, over) for p in (4096, 16384)
       for tag, over in (("at", 0), ("over", 1))},
    "corrupt_none": _corrupt(lambda b, root: None),
    "corrupt_entries_lie": _corrupt(lambda b, root: struct.pack_into(
        "<Q", b, _META_MAIN + 32, 299)),
    "corrupt_root_pgno": _corrupt(lambda b, root: struct.pack_into(
        "<Q", b, root * 4096, root + 1)),
    "corrupt_lower_above_upper": _corrupt(lambda b, root: struct.pack_into(
        "<H", b, root * 4096 + 12, 4090)),
    "corrupt_magic": _corrupt(lambda b, root: struct.pack_into(
        "<I", b, 16, 0)),
    "corrupt_depth_lie": _corrupt(lambda b, root: struct.pack_into(
        "<H", b, _META_MAIN + 6, 5)),
    "corrupt_leaf_count_lie": _corrupt(lambda b, root: struct.pack_into(
        "<Q", b, _META_MAIN + 16, 1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_validators_agree(tmp_path, case):
    kind, result = _agree(CASES[case](tmp_path))
    if case.startswith(("messy", "deep", "fuzzed", "nodemax")) \
            or case == "corrupt_none":
        assert kind == "ok", result
        if case.startswith("deep"):
            assert result["depth"] == 3
            assert result["psize"] == int(case.split("_")[1])
        if case.startswith("nodemax"):
            assert result["overflow_pages"] == int(case.endswith("over"))
        if case == "corrupt_none":
            assert result["entries"] == len(_valid_items())
    else:
        assert kind == "error", result
        if case == "leaf2_rejected":
            assert "unexpected flags" in result
        if case == "dupsort_rejected":
            assert "DUPSORT" in result


def test_port_writer_output_is_the_jax_writers():
    """The files the port's writer builds for these cases are byte for byte
    those of the JAX package's writer, so the cases above cover both."""
    import tempfile

    from coclr_tpu.data.lmdb_format import write_lmdb as jax_write

    items = _valid_items()
    with tempfile.TemporaryDirectory() as d:
        a = write_lmdb(d + "/a.lmdb", items.items(), psize=8192)
        b = jax_write(d + "/b.lmdb", items.items(), psize=8192)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
