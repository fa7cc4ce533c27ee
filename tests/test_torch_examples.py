"""The port's examples (``examples/port_*.py``) run on the CPU at their
smallest settings: each in a subprocess with ``--device cpu``, all four
started together as the module begins; each exits 0 within its timeout
and prints its key line. (``--hetero``'s co-sort is
``launch.mesh.co_sort``, held to the reference in
``tests/test_torch_hetero.py``.)"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
#: example -> (arguments, a line its output must hold)
RUNS = {
    "port_quickstart": (["--n", "4096"],
                        "cuda backend      : identical sort"),
    "port_distributed_sort": (["--n", "4096"],
                              "every key/payload pair survived"),
    "port_serve_llm": (["--batch", "2", "--prompt-len", "8", "--max-new",
                        "8", "--paged"], "decode : "),
    "port_train_moe": (["--steps", "1", "--batch", "2", "--seq", "16"],
                       "loss: "),
}


@pytest.fixture(scope="module")
def runs():
    # one torch thread a process: the four examples and the distributed
    # one's ranks run at once beside the suite's other workers
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", name + ".py"),
         "--device", "cpu", *args], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, (args, _) in RUNS.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=TIMEOUT)
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_example_runs_on_the_cpu(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, stderr[-4000:]
    assert RUNS[name][1] in stdout, stdout[-2000:]


def test_distributed_example_counts_one_exchange_a_sort(runs):
    _, stdout, _ = runs["port_distributed_sort"]
    assert stdout.count("collectives a rank 19 (all_to_all 1)") == 3
