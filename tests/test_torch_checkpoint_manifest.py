"""The checkpoint manifest's commit protocol in the port
(`accelerate_tpu_torch/utils/manifest.py`, a copy) against the JAX
package's `accelerate_tpu/utils/manifest.py`: the reference's cases, each
run on both modules over the same directory trees, and manifests written
by one package read identically by the other (name, version, JSON layout
and the (step, commit time) order are shared)."""

from __future__ import annotations

import json
import os

import pytest

from accelerate_tpu.utils import manifest as jm
from accelerate_tpu_torch.utils import manifest as tm

IMPLS = pytest.mark.parametrize("m", [tm, jm], ids=["port", "jax"])


def _commit(m, base, name, step, files=("a.bin",)):
    d = os.path.join(str(base), name)
    os.makedirs(d, exist_ok=True)
    for f in files:
        with open(os.path.join(d, f), "wb") as fh:
            fh.write(b"x")
    m.write_manifest(d, step=step, files=files)
    return d


@IMPLS
def test_write_read_roundtrip(m, tmp_path):
    d = _commit(m, tmp_path, "step_1", 1, files=("a.bin", "b.bin"))
    got = m.read_manifest(d)
    assert got["step"] == 1
    assert sorted(got["files"]) == ["a.bin", "b.bin"]
    assert m.is_complete(d)


@IMPLS
def test_missing_manifest_is_absent(m, tmp_path):
    d = os.path.join(str(tmp_path), "torn")
    os.makedirs(d)
    with open(os.path.join(d, "a.bin"), "wb") as fh:
        fh.write(b"x")  # bytes landed, commit never happened
    assert m.read_manifest(d) is None
    assert not m.is_complete(d)
    assert m.latest_complete(str(tmp_path)) is None


@IMPLS
def test_corrupt_manifest_is_absent(m, tmp_path):
    d = _commit(m, tmp_path, "step_1", 1)
    with open(os.path.join(d, m.MANIFEST_NAME), "w") as fh:
        fh.write('{"version": 1, "ste')  # torn at an arbitrary byte offset
    assert m.read_manifest(d) is None
    assert not m.is_complete(d)


@IMPLS
def test_manifest_wrong_shape_is_absent(m, tmp_path):
    d = os.path.join(str(tmp_path), "odd")
    os.makedirs(d)
    with open(os.path.join(d, m.MANIFEST_NAME), "w") as fh:
        json.dump(["not", "a", "manifest"], fh)
    assert m.read_manifest(d) is None


@IMPLS
def test_listed_file_missing_means_incomplete(m, tmp_path):
    d = _commit(m, tmp_path, "step_1", 1, files=("a.bin", "b.bin"))
    os.remove(os.path.join(d, "b.bin"))
    assert m.read_manifest(d) is not None  # manifest parses...
    assert not m.is_complete(d)            # ...but the commit is void


@IMPLS
def test_latest_complete_picks_highest_step(m, tmp_path):
    _commit(m, tmp_path, "step_2", 2)
    _commit(m, tmp_path, "step_10", 10)
    _commit(m, tmp_path, "step_5", 5)
    # a torn later save must not win
    os.makedirs(os.path.join(str(tmp_path), "step_11"))
    assert m.latest_complete(str(tmp_path)).endswith("step_10")
    names = [os.path.basename(p)
             for p in m.complete_checkpoints(str(tmp_path))]
    assert names == ["step_2", "step_5", "step_10"]


@IMPLS
def test_base_dir_itself_can_be_the_checkpoint(m, tmp_path):
    d = _commit(m, tmp_path, ".", 7)
    assert m.latest_complete(d) == os.path.abspath(d)


@IMPLS
def test_prune_keeps_newest(m, tmp_path):
    for s in (1, 2, 3, 4):
        _commit(m, tmp_path, f"step_{s}", s)
    removed = m.prune_complete(str(tmp_path), keep_last_n=2)
    assert sorted(os.path.basename(p) for p in removed) == [
        "step_1", "step_2"]
    assert m.latest_complete(str(tmp_path)).endswith("step_4")


@IMPLS
def test_prune_clamps_to_one_and_never_deletes_newest(m, tmp_path):
    for s in (1, 2):
        _commit(m, tmp_path, f"step_{s}", s)
    m.prune_complete(str(tmp_path), keep_last_n=0)  # clamped to keep >= 1
    assert m.latest_complete(str(tmp_path)).endswith("step_2")


@IMPLS
def test_prune_skips_protected_and_incomplete(m, tmp_path):
    kept = _commit(m, tmp_path, "step_1", 1)
    _commit(m, tmp_path, "step_2", 2)
    _commit(m, tmp_path, "step_3", 3)
    torn = os.path.join(str(tmp_path), "step_0")
    os.makedirs(torn)  # incomplete: not prune_complete's to delete
    removed = m.prune_complete(str(tmp_path), keep_last_n=1,
                               protected=(kept,))
    assert [os.path.basename(p) for p in removed] == ["step_2"]
    assert os.path.isdir(kept) and os.path.isdir(torn)


@IMPLS
def test_atomic_replace_no_partial_manifest_visible(m, tmp_path):
    # overwriting a manifest goes through tmp+rename: a reader can only
    # ever see the old or the new version, never a torn one
    d = _commit(m, tmp_path, "step_1", 1)
    m.write_manifest(d, step=1, files=("a.bin",), extra={"round": 2})
    got = m.read_manifest(d)
    assert got["extra"]["round"] == 2
    leftovers = [f for f in os.listdir(d)
                 if f not in ("a.bin", m.MANIFEST_NAME)]
    assert leftovers == []


@pytest.mark.parametrize("writer,reader", [(tm, jm), (jm, tm)],
                         ids=["port_to_jax", "jax_to_port"])
def test_a_manifest_from_one_package_reads_the_same_in_the_other(
        writer, reader, tmp_path):
    for s, name in ((3, "step_3"), (12, "step_12"), (7, "step_7")):
        _commit(writer, tmp_path, name, s, files=("a.bin", "b.bin"))
    writer.write_manifest(os.path.join(str(tmp_path), "step_7"), step=7,
                          files=("a.bin", "b.bin"), extra={"k": [1, 2]})
    os.makedirs(os.path.join(str(tmp_path), "step_99"))  # torn
    base = str(tmp_path)
    assert reader.MANIFEST_NAME == writer.MANIFEST_NAME
    assert reader.MANIFEST_VERSION == writer.MANIFEST_VERSION
    assert reader.complete_checkpoints(base) == \
        writer.complete_checkpoints(base)
    for d in writer.complete_checkpoints(base):
        assert reader.read_manifest(d) == writer.read_manifest(d)
        with open(os.path.join(d, writer.MANIFEST_NAME), "rb") as fh:
            written = fh.read()
        reader.write_manifest(d, **{k: v for k, v in
                                    reader.read_manifest(d).items()
                                    if k in ("step", "files", "extra")})
        with open(os.path.join(d, reader.MANIFEST_NAME), "rb") as fh:
            assert fh.read() == written   # byte for byte
    assert reader.latest_complete(base).endswith("step_12")
