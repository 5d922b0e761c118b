"""The port's download CLI (uncrtaints_tpu_torch/cli/download.py), mirroring
tests/test_cli_download.py: the manifest of the reference's dl_data.sh
(archive names, mediaTUM object ids and sizes), the plan, the dry run and
the s2cloudless weights plan into the port's own cache. Nothing here
touches the network: no step of kind "download" is run."""

import os
import shutil
import tarfile

import pytest

from uncrtaints_tpu.cli import download as jdl
from uncrtaints_tpu_torch.cli import download as dl


@pytest.mark.parametrize("dataset, splits, regions, mods, seasons", [
    ("sen12mscrts", ["train"], dl.REGIONS, ["s2", "s1"], None),
    ("sen12mscrts", ["test"], ["asiaWest"], ["s2", "s1"], None),
    ("sen12mscrts", ["train", "test"], ["africa", "europa"], ["s1"], None),
    ("sen12mscr", [], [], ["s2"], ["spring"]),
    ("sen12mscr", [], [], ["s2", "s1"], None),
])
def test_manifest_equals_the_jax_packages(dataset, splits, regions, mods, seasons):
    got = dl.build_manifest(dataset, splits, regions, mods, seasons=seasons)
    ref = jdl.build_manifest(dataset, splits, regions, mods, seasons=seasons)
    key = lambda m: [(a.object_id, a.filename, a.sectors, a.extract_root, a.arrange, a.url)
                     for a in m]
    assert key(got) == key(ref) and got
    assert dl.fetch_steps(got, "/data") == jdl.fetch_steps(ref, "/data")


def test_ts_archive_names_and_sizes_match_the_reference():
    m = dl.build_manifest("sen12mscrts", ["train"], dl.REGIONS, ["s2", "s1"])
    assert {a.filename for a in m} == {f"{mod}_{r}.tar.gz" for mod in ("s1", "s2")
                                       for r in dl.REGIONS}
    assert all(a.object_id == "1639953" for a in m)
    by_name = {a.filename: a.sectors for a in m}
    assert by_name["s2_africa.tar.gz"] == 98233900
    assert by_name["s1_europa.tar.gz"] == 121213836
    m = dl.build_manifest("sen12mscrts", ["test"], ["asiaWest"], ["s2", "s1"])
    assert {a.filename for a in m} == {"s2_asiaWest_test.tar.gz", "s1_asiaWest_test.tar.gz"}
    assert all(a.object_id == "1659251" for a in m)
    assert {a.sectors for a in m} == {15012924, 9252904}


def test_cr_manifest_includes_paired_cloudy():
    m = dl.build_manifest("sen12mscr", [], [], ["s2"], seasons=["spring"])
    assert {a.filename for a in m} == {"ROIs1158_spring_s2.tar.gz",
                                       "ROIs1158_spring_s2_cloudy.tar.gz"}
    m = dl.build_manifest("sen12mscr", [], [], ["s2", "s1"])
    assert len(m) == 12 and {a.object_id for a in m} == {"1554803"}
    by_name = {a.filename: a.sectors for a in m}
    assert by_name["ROIs2017_winter_s1.tar.gz"] == 9460956
    assert by_name["ROIs1970_fall_s2_cloudy.tar.gz"] == 68292448


def test_url_format_matches_the_reference():
    a = dl.build_manifest("sen12mscrts", ["train"], ["africa"], ["s2"])[0]
    assert a.url == "https://dataserv.ub.tum.de/s/m1639953/download?path=/&files=s2_africa.tar.gz"


def test_disk_space_check(tmp_path):
    m = dl.build_manifest("sen12mscrts", ["train"], dl.REGIONS, ["s1", "s2"])
    if dl.available_sectors(str(tmp_path)) < dl.required_sectors(m):
        with pytest.raises(RuntimeError, match="Not enough space"):
            dl.check_disk_space(m, str(tmp_path))
    tiny = dl.build_manifest("sen12mscrts", ["train"], ["africa"], ["s2"])[:1]
    tiny[0].sectors = 1
    dl.check_disk_space(tiny, str(tmp_path))


def test_fetch_steps_order_and_arrange():
    m = dl.build_manifest("sen12mscrts", ["train", "test"], ["africa"], ["s2"])
    steps = dl.fetch_steps(m, "/data")
    kinds = [s[0] for s in steps]
    assert kinds[0] == "mkdir" and steps[0][1] == "/data/SEN12MSCRTS"
    assert kinds[1:7] == ["download", "extract", "rm"] * 2 and kinds[7:] == ["merge", "merge"]
    assert steps[7][1:] == ("/data/africa", "/data/SEN12MSCRTS")
    assert steps[8][1:] == ("/data/s2_africa_test", "/data/SEN12MSCRTS")
    msteps = dl.fetch_steps(dl.build_manifest("sen12mscr", [], [], ["s1"], seasons=["winter"]),
                            "/d")
    assert msteps[0] == ("mkdir", "/d/SEN12MSCR")
    assert msteps[-1] == ("move", "/d/ROIs2017_winter_s1", "/d/SEN12MSCR")


def test_run_steps_end_to_end_without_the_download(tmp_path):
    """A plan run against an archive made here: extract, delete, merge into
    the SEN12MSCRTS layout."""
    src = tmp_path / "africa" / "ROIs0000" / "1" / "S2" / "0"
    os.makedirs(src)
    (src / "img.tif").write_bytes(b"x")
    ar = tmp_path / "s2_africa.tar.gz"
    with tarfile.open(ar, "w:gz") as t:
        t.add(tmp_path / "africa", arcname="africa")
    shutil.rmtree(tmp_path / "africa")
    m = dl.build_manifest("sen12mscrts", ["train"], ["africa"], ["s2"])
    for s in dl.fetch_steps(m, str(tmp_path)):
        if s[0] != "download":
            dl.run_step(s)
    assert (tmp_path / "SEN12MSCRTS" / "ROIs0000" / "1" / "S2" / "0" / "img.tif").exists()
    assert not ar.exists() and not (tmp_path / "africa").exists()


def test_merge_tree_merges_into_existing(tmp_path):
    a = tmp_path / "new" / "ROIs0000" / "5" / "S1" / "0"
    b = tmp_path / "SEN12MSCRTS" / "ROIs0000" / "1" / "S1" / "0"
    os.makedirs(a), os.makedirs(b)
    (a / "n.tif").write_bytes(b"n")
    (b / "o.tif").write_bytes(b"o")
    dl._merge_tree(str(tmp_path / "new"), str(tmp_path / "SEN12MSCRTS"))
    root = tmp_path / "SEN12MSCRTS" / "ROIs0000"
    assert (root / "5" / "S1" / "0" / "n.tif").exists() and (root / "1" / "S1" / "0" / "o.tif").exists()


def test_dry_run_prints_the_plan(capsys, tmp_path):
    plan = str(tmp_path / "plan")
    dl.main(dl.create_parser().parse_args(
        ["--dataset", "sen12mscrts", "--splits", "test", "--regions", "africa",
         "--modalities", "s2", "--dest", plan, "--skip_space_check"]))
    out = capsys.readouterr().out
    assert "s2_africa_test.tar.gz" in out and "dry run" in out
    assert "wget --no-check-certificate -c" in out
    assert not os.path.exists(plan)  # a dry run makes nothing


def test_s2cloudless_weights_plan_targets_the_ports_cache(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    dl.main(dl.create_parser().parse_args(["--s2cloudless-weights"]))
    out = capsys.readouterr().out
    assert os.path.join(str(tmp_path), "uncrtaints_tpu_torch", dl.S2CLOUDLESS_MODEL) in out
    assert dl.S2CLOUDLESS_URL == jdl.S2CLOUDLESS_URL
    assert not os.path.exists(tmp_path / "uncrtaints_tpu_torch")  # planned, not run
