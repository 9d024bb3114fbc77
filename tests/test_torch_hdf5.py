"""The port's HDF5 reader (behindthescenes_tpu_torch/datasets/hdf5.py)
against h5py on files that h5py writes here: every element equal (the
reader copies bytes; no arithmetic), the file's dtype and shape kept,
one index read without reading the whole dataset, and what the reader
does not support raising NotImplementedError.
"""
import h5py
import numpy as np
import pytest
import torch

from behindthescenes_tpu_torch.datasets import hdf5

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

DTYPES = ["u1", "<u2", ">u2", "<f4", ">f4", "<f8", ">f8", "<i2", ">i4"]


def _data(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(0, 100, shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dt)


def _compact():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return {"dcpl": dcpl}


def _write(path, datasets, userblock=0, libver="earliest"):
    with h5py.File(path, "w", userblock_size=userblock,
                   libver=libver) as f:
        for name, (data, kw) in datasets.items():
            f.create_dataset(name, data=data, **kw)


def _check_equal(path, names):
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        for name in names:
            w = want[name][()]
            g = got[name][()]
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w)
            for i in (0, len(w) - 1, -1):
                np.testing.assert_array_equal(got[name][i], w[i])
            np.testing.assert_array_equal(got[name][1:3], w[1:3])


@pytest.mark.parametrize("userblock", [0, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_layouts_and_dtypes_equal_h5py(tmp_path, dtype, userblock):
    path = tmp_path / "a.h5"
    shape = (5, 7, 9)
    _write(path, {
        "contiguous": (_data(dtype, shape, 0), {}),
        "compact": (_data(dtype, (3, 4), 1), _compact()),
        "gzip": (_data(dtype, shape, 2), {"chunks": (2, 3, 4),
                                          "compression": "gzip"}),
        "shuffle_gzip": (_data(dtype, shape, 3),
                         {"chunks": (1, 7, 5), "compression": "gzip",
                          "compression_opts": 9, "shuffle": True}),
        "chunked_plain": (_data(dtype, shape, 4), {"chunks": (3, 2, 9)}),
    }, userblock=userblock)
    if userblock:
        assert open(path, "rb").read(8) != b"\x89HDF\r\n\x1a\n"
    _check_equal(path, ["contiguous", "compact", "gzip", "shuffle_gzip",
                        "chunked_plain"])


def test_matlab_like_layout(tmp_path):
    """MATLAB v7.3's shape: a 512-byte user block, (N, 3, W, H) uint8
    images and (N, W, H) float32 depths, chunked a frame at a time with
    deflate, edge chunks at W and H."""
    path = tmp_path / "nyu.mat"
    imgs = _data("u1", (3, 3, 40, 30), 5)
    depths = _data("<f4", (3, 40, 30), 6)
    _write(path, {"images": (imgs, {"chunks": (1, 3, 16, 16),
                                    "compression": "gzip"}),
                  "depths": (depths, {"chunks": (2, 16, 16),
                                      "compression": "gzip",
                                      "compression_opts": 3})},
           userblock=512)
    _check_equal(path, ["images", "depths"])


def test_nested_groups_many_members_and_continuations(tmp_path):
    """Nested groups; a group of 40 members (several symbol-table nodes
    under its B-tree); a dataset whose 40 attributes push its header into
    continuation blocks."""
    path = tmp_path / "g.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("a/b/c/x", data=_data("<f4", (4, 3), 7))
        big = f.create_group("many")
        for i in range(40):
            big.create_dataset(f"d{i:02d}", data=np.full((2,), i, np.int32))
        ds = f.create_dataset("attrs", data=_data(">f8", (6, 2), 8))
        for i in range(40):
            ds.attrs[f"attribute_{i:02d}"] = np.arange(i + 1)
        f.create_dataset("scalar", data=np.float64(2.5))
    with hdf5.File(path) as got:
        assert sorted(got.keys()) == ["a", "attrs", "many", "scalar"]
        assert isinstance(got["a/b"], hdf5.Group)
        assert "c" in got["a/b"]
        assert sorted(got["many"].keys()) == [f"d{i:02d}" for i in range(40)]
        for i in range(40):
            np.testing.assert_array_equal(got[f"many/d{i:02d}"][()],
                                          [i, i])
        assert got["scalar"][()] == 2.5 and got["scalar"].shape == ()
        assert "missing" not in got
        with pytest.raises(KeyError):
            got["a/nothing"]
    _check_equal(path, ["a/b/c/x", "attrs"])


def test_latest_format_superblock_and_link_messages(tmp_path):
    """libver='latest': superblock version 3, version-2 object headers,
    groups by link messages; contiguous and compact data read, and a
    chunked dataset (a fixed-array chunk index) raises."""
    path = tmp_path / "new.h5"
    _write(path, {"g/contiguous": (_data("<u2", (6, 5), 9), {}),
                  "g/compact": (_data(">f4", (2, 3), 10), _compact()),
                  "chunked": (_data("<f4", (6, 5), 11), {"chunks": (2, 5)})},
           userblock=1024, libver="latest")
    assert open(path, "rb").read(1032)[1024:1032] == b"\x89HDF\r\n\x1a\n"
    _check_equal(path, ["g/contiguous", "g/compact"])
    with hdf5.File(path) as got:
        with pytest.raises(NotImplementedError, match="chunk index"):
            got["chunked"]


@pytest.mark.parametrize("kw,what", [
    ({"compression": "lzf"}, "filter 32000"),
    ({"fletcher32": True}, "filter 3"),
    ({"scaleoffset": 2}, "filter 6")])
def test_unsupported_filters_raise(tmp_path, kw, what):
    path = tmp_path / "f.h5"
    _write(path, {"x": (_data("<f4", (8, 8), 12), dict(chunks=(4, 4), **kw)),
                  "ok": (np.arange(3), {})})
    with hdf5.File(path) as got:
        np.testing.assert_array_equal(got["ok"][()], np.arange(3))
        with pytest.raises(NotImplementedError, match=what):
            got["x"]


def test_unsupported_datatypes_raise(tmp_path):
    path = tmp_path / "t.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("s", data=np.array([b"ab", b"cd"]))
        f.create_dataset("c", data=np.zeros(2, [("a", "<f4"), ("b", "<i2")]))
        f["ref"] = f["s"].ref
        f["soft"] = h5py.SoftLink("/s")
    with hdf5.File(path) as got:
        with pytest.raises(NotImplementedError, match="string"):
            got["s"]
        with pytest.raises(NotImplementedError, match="compound"):
            got["c"]
        with pytest.raises(NotImplementedError, match="reference"):
            got["ref"]
        with pytest.raises(NotImplementedError, match="soft link"):
            got["soft"]
    with pytest.raises(ValueError, match="no HDF5 superblock"):
        hdf5.File(__file__)


def test_one_index_reads_only_its_chunks_and_bytes(tmp_path, monkeypatch):
    """ds[i] reads the chunks (chunked) or the row (contiguous) that hold
    index i, not the dataset."""
    path = tmp_path / "big.h5"
    data = _data("<f4", (16, 64, 64), 13)
    _write(path, {"chunked": (data, {"chunks": (1, 64, 64),
                                     "compression": "gzip"}),
                  "contiguous": (data, {})}, userblock=512)
    read = []
    orig = hdf5._Reader.read

    def counting(self, offset, n):
        read.append(n)
        return orig(self, offset, n)
    monkeypatch.setattr(hdf5._Reader, "read", counting)
    with hdf5.File(path) as got:
        for name in ("chunked", "contiguous"):
            ds = got[name]
            ds._chunk_index = ds._chunks() if name == "chunked" else None
            read.clear()
            np.testing.assert_array_equal(ds[7], data[7])
            assert sum(read) <= 64 * 64 * 4 + 64, (name, read)
