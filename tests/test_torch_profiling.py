"""`hsc_torch.utils.profiling` on the CPU: `profile_region` writes a Chrome
trace that holds the spans `scope` names, under the file name given, and
does nothing without a directory."""

import json

import torch

from hsc_torch.utils.profiling import profile_region, scope


def _names(path) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profile_region_writes_a_trace_with_the_scope(tmp_path):
    with profile_region(str(tmp_path / "trace"), "cpu"):
        with scope("test/compute"):
            float((torch.arange(128.0) * 2.0).sum())
    assert "test/compute" in _names(tmp_path / "trace" / "trace.json")


def test_profile_region_takes_a_file_name(tmp_path):
    with profile_region(str(tmp_path), torch.device("cpu"), "encode.trace.json"):
        with scope("encode"):
            torch.ones(4).sum()
    assert [p.name for p in tmp_path.iterdir()] == ["encode.trace.json"]
    assert "encode" in _names(tmp_path / "encode.trace.json")


def test_profile_region_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ran = []
    with profile_region(None, "cpu"):
        with scope("test/compute"):
            ran.append(float(torch.ones(4).sum()))
    assert ran == [4.0] and not list(tmp_path.iterdir())
