"""The port's HDF5 reader and writer (``sparkdl_tpu_torch.utils.hdf5``)
held to ``h5py``.

Files that ``h5py`` writes here (its defaults, as Keras uses them) are read
by both and compared object by object: nested groups (one with more than
300 children, so its B-tree spans many symbol-table nodes), f16 / f32 /
f64 / integer datasets, scalar, empty and compact ones, fixed- and
variable-length string attributes (scalar and arrays), and an object whose
many attributes spill into continuation blocks; and the latest format
(superblock 3, version-2 headers, link messages). Chunked and compressed
datasets, and links in dense storage, raise naming the object. Files the
writer makes read back in ``h5py`` exactly.
"""

import io

import h5py
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sparkdl_tpu_torch.utils import hdf5


def _same(a, b, path="/"):
    """Compare an ``h5py`` object with the reader's, recursively; returns
    the count of datasets compared."""
    assert sorted(a.attrs.keys()) == sorted(b.attrs.keys()), path
    for key in a.attrs:
        want, got = a.attrs[key], b.attrs[key]
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and got.shape == want.shape, (path, key)
            assert got.dtype == want.dtype, (path, key, got.dtype, want.dtype)
            assert np.array_equal(got, want), (path, key)
        else:
            assert type(got) is type(want) and got == want, (path, key, got, want)
    if isinstance(a, h5py.Dataset):
        want, got = a[()], b.read()
        assert got.shape == want.shape and got.dtype == want.dtype, path
        assert np.array_equal(got, want), path
        return 1
    assert list(a.keys()) == b.keys(), path
    return sum(_same(a[k], b[k], f"{path}{k}/") for k in a.keys())


@pytest.fixture(scope="module")
def h5py_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("hdf5") / "h5py.h5"
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = '{"class_name": "Functional"}' * 3000  # global heap
        f.attrs["names"] = ["conv2d", "batch_normalization", "dense"]
        f.attrs["fixed"] = np.bytes_("fixed-length")
        f.attrs["fixed_array"] = np.array([b"ab", b"cde"], dtype="S3")
        f.attrs["empty"] = np.array([], dtype=np.float64)
        f.attrs["scalar_int"] = np.int32(-7)
        f.attrs["vector"] = np.arange(5, dtype=np.float32)
        big = f.create_group("layers")
        for i in range(313):
            vars_ = big.create_group(f"layer_{i}").create_group("vars")
            vars_.attrs["name"] = f"layer_{i}"
            vars_["0"] = rng.standard_normal((3, 1 + i % 4)).astype(np.float32)
        data = f.create_group("a").create_group("b").create_group("c")
        data["f16"] = rng.standard_normal((4, 5)).astype(np.float16)
        data["f32"] = rng.standard_normal((2, 3, 4)).astype(np.float32)
        data["f64"] = rng.standard_normal(7)
        data["i64"] = rng.integers(-100, 100, (3, 3))
        data["u8"] = rng.integers(0, 255, 10).astype(np.uint8)
        data["big_endian"] = np.arange(6, dtype=">f4").reshape(2, 3)
        data["scalar"] = np.float64(2.5)
        data["empty"] = np.zeros((0, 3), np.float32)
        data.create_dataset("compact", data=np.arange(4, dtype=np.int16),
                            dcpl=_compact_dcpl())
        data["strings"] = np.array(["x", "yy", "zzz"], dtype=h5py.string_dtype())
        many = f.create_group("many_attrs")
        for i in range(40):
            many.attrs[f"attr_{i:02d}"] = f"value {i} " * 20
    return str(path)


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


def test_reads_what_h5py_writes(h5py_file):
    ours = hdf5.File(h5py_file)
    with h5py.File(h5py_file, "r") as theirs:
        assert _same(theirs, ours) == 313 + 10
        assert len(ours["layers"]) == 313
        # messages that live in continuation blocks
        assert len(ours["many_attrs"].attrs) == 40
        assert theirs["a/b/c/compact"].id.get_create_plist().get_layout() == h5py.h5d.COMPACT


def test_reads_from_bytes_and_returns_views_in_file_byte_order(h5py_file):
    with open(h5py_file, "rb") as fh:
        blob = fh.read()
    ours = hdf5.File(blob)
    big_endian = ours["a/b/c/big_endian"].read()
    assert big_endian.dtype == np.dtype(">f4")
    assert not big_endian.flags.writeable  # a view of the bytes, not a copy
    np.testing.assert_array_equal(big_endian, np.arange(6).reshape(2, 3))
    assert ours["a/b/c/scalar"].shape == () and ours["a/b/c/scalar"].read() == 2.5
    assert ours.attrs["names"].tolist() == ["conv2d", "batch_normalization", "dense"]
    assert "a/b/c/f32" in ours and "a/b/nope" not in ours
    with pytest.raises(KeyError):
        ours["a/b/nope"]


def test_reads_the_latest_format_with_compact_links(tmp_path):
    """Superblock 3, version-2 object headers, groups as link messages;
    a group past 8 links keeps them in a fractal heap, which raises."""
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(5):
            f[f"a{i}"] = np.arange(i + 1.0)
        f.attrs["names"] = ["a", "bb"]
        f.attrs["text"] = "x"
        f.create_group("sub")["c"] = np.int8(3)
        dense = f.create_group("dense")
        for i in range(20):
            dense[f"d{i}"] = np.zeros(1)
    assert path.read_bytes()[8] == 3
    ours = hdf5.File(str(path))
    with h5py.File(path, "r") as theirs:
        for key in ("a0", "a4", "sub/c"):
            assert _same(theirs[key], ours[key]) == 1
        assert ours.attrs["names"].tolist() == ["a", "bb"] and ours.attrs["text"] == "x"
    with pytest.raises(NotImplementedError, match="dense"):
        ours["dense"]


@pytest.mark.parametrize("kind", ["chunked", "gzip"])
def test_chunked_and_filtered_datasets_raise_with_their_name(tmp_path, kind):
    path = tmp_path / f"{kind}.h5"
    with h5py.File(path, "w") as f:
        f["plain"] = np.ones(3)
        f.create_dataset("packed", data=np.ones((8, 8)), chunks=(4, 4),
                         compression="gzip" if kind == "gzip" else None)
    ours = hdf5.File(str(path))
    np.testing.assert_array_equal(ours["plain"].read(), np.ones(3))
    with pytest.raises(NotImplementedError, match="packed"):
        ours["packed"]


def test_writer_files_read_back_in_h5py(tmp_path):
    rng = np.random.default_rng(1)
    tree = {
        "layers": {f"l{i:03d}": {"vars": {"0": rng.standard_normal((2, i % 3 + 1))
                                                  .astype(np.float32)}}
                   for i in range(333)},
        "vars": {},
        "mixed": {"f16": np.ones(3, np.float16), "f64": np.float64(3.5),
                  "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "empty": np.zeros((0, 4), np.float32)},
    }
    attrs = {"": {"root": "top"}, "layers/l007/vars": {"name": "l007"},
             "vars": {"name": "model"}, "mixed/f16": {"unit": "héllo"}}
    path = tmp_path / "written.h5"
    blob = hdf5.write(str(path), tree, attrs)
    assert path.read_bytes() == blob
    with h5py.File(path, "r") as theirs:
        assert len(theirs["layers"]) == 333
        assert theirs["layers/l007/vars"].attrs["name"] == b"l007"
        assert theirs["mixed/f16"].attrs["unit"].decode("utf-8") == "héllo"
        for i in (0, 150, 332):
            np.testing.assert_array_equal(theirs[f"layers/l{i:03d}/vars/0"][()],
                                          tree["layers"][f"l{i:03d}"]["vars"]["0"])
        for key, value in tree["mixed"].items():
            got = theirs[f"mixed/{key}"][()]
            assert got.dtype == np.asarray(value).dtype
            np.testing.assert_array_equal(got, value)
        assert _same(theirs, hdf5.File(blob)) == 333 + 4


@settings(max_examples=25, deadline=None)
@given(
    shape=st.lists(st.integers(0, 4), min_size=0, max_size=3),
    dtype=st.sampled_from(["<f2", "<f4", "<f8", "<i1", "<i4", "<i8", "<u2", ">f4", ">i4"]),
    seed=st.integers(0, 2**16),
)
def test_any_shape_and_dtype_round_trips(shape, dtype, seed):
    values = (np.random.default_rng(seed).standard_normal(shape) * 50).astype(dtype)
    h5py_buf = io.BytesIO()
    with h5py.File(h5py_buf, "w") as f:
        f["x"] = values
    for blob in (h5py_buf.getvalue(), hdf5.write(None, {"x": values})):
        got = hdf5.File(blob)["x"].read()
        assert got.shape == values.shape
        np.testing.assert_array_equal(got, values)
        with h5py.File(io.BytesIO(blob), "r") as f:
            np.testing.assert_array_equal(f["x"][()], values)
