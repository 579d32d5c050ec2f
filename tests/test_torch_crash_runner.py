"""The crash-aware local-cluster runner (``topology.run_resilient_cluster``)
under the two races of a gloo cluster, made to happen on purpose by a
program that needs no torch (each test runs in a second or two):

* a failed bring-up — rank 0 exits before any heartbeat, as when another
  process takes the rendezvous port between ``_free_port`` and the bind,
  while rank 1 waits to connect — is launched again under the
  ``RetryPolicy``, as ``spawn_local_cluster`` does;
* a survivor that exits nonzero milliseconds after its peer's injected
  crash, as gloo throws a rank out of the collective its dead peer left, is
  not a dead rank: ``dead_ranks`` keeps the reference's meaning, the rank
  that died on its own.

Rank 0 listens on the attempt's coordinator port and rank 1 connects; each
round both send one byte and read one (a collective), then print the
heartbeat. Rank 1 hard-exits at the top of round 3, and rank 0 is thrown out
of that round's exchange.
"""

import signal
import sys

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.launch import topology as topo
from repro_torch.launch.transport import RetryPolicy

RETRY = RetryPolicy(timeout_s=60.0, retries=2, backoff_s=0.05)

_PROG = r"""
import os, socket, sys, time
pid = int(os.environ[{process!r}].split("/")[0])
host, port = os.environ[{coord!r}].rsplit(":", 1)
mark = os.path.join(os.environ["RACE_DIR"], "bind_failed")
if pid == 0 and (os.environ.get("RACE_FAIL_ALWAYS") == "1" or not os.path.exists(mark)):
    open(mark, "w").close()   # the port was taken: rank 0 cannot bind it
    sys.exit(3)
if pid == 0:
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, int(port)))
    srv.listen(1)
    conn, _ = srv.accept()
else:
    for _ in range(1000):
        try:
            conn = socket.create_connection((host, int(port)))
            break
        except OSError:
            time.sleep(0.01)
crash = int(os.environ.get("RACE_CRASH_ROUND", "-1"))
for k in range(int(os.environ.get("RACE_ROUNDS", "5"))):
    if k == crash and pid == 1:
        os._exit(17)
    try:
        conn.sendall(b"x")
        got = conn.recv(1)
    except OSError:
        got = b""
    if not got:                 # the peer is gone: thrown out of the exchange
        time.sleep(0.02)
        sys.exit(1)
    print({hb!r}, k, flush=True)
""".format(process=topo.PROCESS_ENV, coord=topo.COORD_ENV, hb=topo.HEARTBEAT)


def _run(tmp_path, **env):
    extra = {"RACE_DIR": str(tmp_path), **{k: str(v) for k, v in env.items()}}
    return topo.run_resilient_cluster(_PROG, num_processes=2, devices_per_process=1,
                                      extra_env=extra, retry=RETRY)


def test_failed_bringup_is_retried_and_a_thrown_out_survivor_is_not_dead(tmp_path):
    outcome = _run(tmp_path, RACE_CRASH_ROUND=3)
    codes = [r.returncode for r in outcome.results]
    assert outcome.attempts == 2, codes
    assert outcome.dead_ranks == (1,), (codes, [r.stderr[-500:] for r in outcome.results])
    assert outcome.crashed and outcome.last_round == 2
    assert codes[1] == 17 and codes[0] != 0


def test_bringup_that_always_fails_returns_the_last_attempt(tmp_path):
    outcome = _run(tmp_path, RACE_FAIL_ALWAYS=1)
    assert outcome.attempts == 1 + RETRY.retries
    assert outcome.last_round == -1 and outcome.crashed
    assert topo.bringup_failed(outcome)
    # rank 0 failed; rank 1, still waiting to connect, was killed
    assert [r.returncode for r in outcome.results] == [3, -signal.SIGKILL]


def test_clean_run_is_not_retried_and_has_no_dead_ranks(tmp_path):
    (tmp_path / "bind_failed").touch()
    outcome = _run(tmp_path, RACE_ROUNDS=4)
    assert outcome.attempts == 1 and outcome.dead_ranks == () and not outcome.crashed
    assert outcome.last_round == 3
    assert not topo.bringup_failed(outcome)
    assert [r.returncode for r in outcome.results] == [0, 0]


def test_first_death_sees_exits_in_the_order_they_happen():
    import subprocess

    progs = ["import time; time.sleep(0.3); raise SystemExit(1)",
             "raise SystemExit(5)",
             "import time; time.sleep(5)"]
    procs = [subprocess.Popen([sys.executable, "-c", p]) for p in progs]
    try:
        assert topo._first_death(procs, 30.0) == (1,)
    finally:
        for p in procs:
            p.kill()
            p.wait()
