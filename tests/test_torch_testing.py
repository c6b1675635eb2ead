"""heat_tpu_torch.testing (the suite runner of ``tools/torch_mpirun.py``) on
the CPU: the protocol and the quarantine give what heat_tpu.testing's give,
the coordinator imports neither torch nor jax, and a 2-rank gloo group runs
a small generated suite through an injected crash on one rank and an
unlabelled hang, recycling the group and finishing the suite.
"""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from tools import mpirun, torch_mpirun  # noqa: E402

ref = mpirun._load_testing()
testing = torch_mpirun._load_testing()

RECORDS = [
    {"kind": "hello", "rank": 0, "pid": 7, "nproc": 2, "v": 1},
    {"kind": "result", "id": "t::a", "outcome": "passed", "rank": 1, "duration": 0.5, "error": "", "exc_type": ""},
    {"cmd": "run", "id": "t::b", "deadline": 5.0},
    {"cmd": "shutdown"},
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_protocol_encodes_and_decodes_as_heat_tpu(i):
    rec = RECORDS[i]
    assert testing.encode(rec) == ref.encode(rec)
    line = testing.encode(rec)
    assert testing.decode(line) == ref.decode(line) == rec
    assert testing.decode("plain pytest output\n") is ref.decode("plain pytest output\n") is None


def test_result_records_and_rank_merges_equal_heat_tpus():
    long = "x" * 10000
    assert testing.result_record("t", "failed", 0, 1.0, error=long) == ref.result_record("t", "failed", 0, 1.0,
                                                                                          error=long)
    cases = [
        [testing.result_record("t", "passed", r, 0.1) for r in range(2)],
        [testing.result_record("t", "passed", 0, 0.1), testing.result_record("t", "failed", 1, 0.2, error="e")],
        [testing.result_record("t", "passed", 0, 0.1), testing.result_record("t", "skipped", 1, 0.2)],
    ]
    for recs in cases:
        assert testing.merge_rank_results(recs) == ref.merge_rank_results(recs)


def test_quarantine_parses_and_matches_as_heat_tpu(tmp_path):
    text = textwrap.dedent("""\
        # a comment
        tests/test_a.py::test_x  # flaky under ws
        tests/test_b.py::  # the whole module: known-bad
    """)
    assert testing.parse_quarantine_text(text) == ref.parse_quarantine_text(text)
    q = testing.parse_quarantine_text(text)
    for tid in ("tests/test_a.py::test_x", "tests/test_a.py::test_y", "tests/test_b.py::test_z"):
        assert testing.match_quarantine(tid, q) == ref.match_quarantine(tid, q)
    with pytest.raises(ValueError):
        testing.parse_quarantine_text("tests/test_a.py::test_x\n")
    assert testing.load_quarantine(str(tmp_path / "missing.txt")) == ref.load_quarantine(str(tmp_path / "no.txt"))
    ids = [f"t::{i}" for i in range(20)]
    assert testing.sample_ids(ids, 5, seed=3) == ref.sample_ids(ids, 5, seed=3)


def test_coordinator_imports_neither_torch_nor_jax():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, 'tools')\n"
         "import torch_mpirun\n"
         "t = torch_mpirun._load_testing()\n"
         "cfg = t.RunnerConfig(world_size=2)\n"
         "assert 'torch' not in sys.modules, 'coordinator imported torch'\n"
         "assert 'jax' not in sys.modules, 'coordinator imported jax'\n"
         "assert 'heat_tpu_torch.core' not in sys.modules\n"],
        capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SUITE = """\
import os
import time

import heat_tpu_torch as ht


def test_a_allreduce():
    t = ht.get_comm().allreduce(ht.array([1.0]).larray)
    assert float(t[0]) == ht.get_comm().size == 2


def test_b_crash_rank_1():
    if os.environ["RANK"] == "1":
        os._exit(11)  # one rank dies: the group is recycled
    time.sleep(60)


def test_c_after_crash():
    assert ht.get_comm().size == 2


def test_d_hang():
    time.sleep(300)  # unlabelled: only the coordinator's deadline ends it


def test_e_after_hang():
    x = ht.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], split=0)
    assert ht.sum(x).item() == 21.0
"""


def test_two_rank_gloo_group_survives_a_crash_and_a_hang(tmp_path):
    suite = tmp_path / "suite"
    suite.mkdir()
    (suite / "test_generated.py").write_text(SUITE)
    streamed = []
    cfg = testing.RunnerConfig(world_size=2, device="cpu", deadline=2.0, grace=1.0, startup_timeout=180.0,
                               max_restarts=3, backoff_base=0.05, backoff_max=0.2, pytest_args=[str(suite)],
                               repo_root=REPO, quarantine_path=str(tmp_path / "none.txt"),
                               log_dir=str(tmp_path / "logs"))
    result = testing.SuiteRunner(cfg, on_event=streamed.append).run()
    out = {tid.rsplit("::", 1)[-1]: rec for tid, rec in result.results.items()}
    assert out["test_a_allreduce"]["outcome"] == "passed", out["test_a_allreduce"]
    assert out["test_b_crash_rank_1"]["outcome"] == "restart-failure"
    assert out["test_c_after_crash"]["outcome"] == "passed"
    assert out["test_d_hang"]["outcome"] == "restart-failure"
    assert out["test_e_after_hang"]["outcome"] == "passed"
    assert result.restarts == 2 and not result.ok
    assert len([e for e in streamed if e.get("kind") == "restart"]) == 2
