"""The ``chains`` mesh axis across processes in the port (torch.distributed
with gloo on the CPU), the counterpart of ``tests/test_multihost.py`` and
``tests/test_parallel.py``'s chain sharding.  The ranks are fresh Python
processes running this file as a script (``python
tests/test_torch_multihost.py <mode> ...``), each under a timeout, all
killed on overrun.

* library, two ranks on ``multihost_worker.py``'s synthetic 6 x 48 DNA
  (numpy seed 7, nst 6 + gamma, 2 runs x 4 chains, seed 11, swapseed 12):
  after 60 generations the gathered lnL has shape (8,) and is finite, gen
  is 60, each run's ``temp_id`` is a permutation, the swap tries sum to
  more than 0, and a block of whole runs a rank makes no collective; the
  gathered starting lnL and lnP equal the one-process port's within 1e-6
  relative and JAX's ``Engine.init_chains`` within 5e-2; carried equals
  recomputed on every rank;
* a world of one gives bit for bit the run of an engine with no process
  group;
* 1 run x 4 chains over two ranks: each generation's gathered swap
  equals the one-process ``_swap_step`` on the same E, ``temp_id`` and
  draws, with one collective a swap generation;
* ranks do not propose in lockstep: one branch-length move from the same
  state on every chain proposes differently on the two ranks;
* per-chain moves: each chain's moves, generation by generation, are the
  one-process draws;
* the CLI under two ranks (``--coordinator/--nprocs/--procid --device
  cpu``) on ``test_multihost.py``'s DRIVE script with ``report
  siterates=yes``: rank 0 writes the file set, logs "Sharding over mesh",
  rank 1 prints no "Consensus" and writes nothing, and the ``.p`` header
  and generation-0 row, report columns included, equal a one-process
  run's; a
  stoprule run stops at the same generation on both ranks; ``append=yes``
  resumes from the checkpoint across two ranks; a rank that raises makes
  both exit non-zero within the timeout.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PRIMATES = os.path.join(HERE, "data", "ref", "examples", "primates.nex")
TIMEOUT = 150           # seconds a launch of ranks may take
SYNTH = dict(nruns=2, nchains=4, seed=11, swapseed=12)

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)


# ---------------------------------------------------------------- ranks

def _synthetic_dataset():
    """multihost_worker.py's 6 x 48 DNA matrix (numpy seed 7)."""
    from mrbayes_tpu_torch.data import DataSet, make_divisions
    from mrbayes_tpu_torch.nexus.datatypes import DataType, FormatInfo
    from mrbayes_tpu_torch.nexus.parser import CharacterMatrix
    rng = np.random.default_rng(7)
    ntax, nchar = 6, 48
    codes = (1 << rng.integers(0, 4, size=(ntax, nchar))).astype(np.uint32)
    m = CharacterMatrix(taxa=[f"t{i}" for i in range(ntax)], nchar=nchar,
                        fmt=FormatInfo(datatype=DataType.DNA), codes=codes,
                        col_datatype=[DataType.DNA] * nchar)
    return DataSet(taxa=m.taxa, nchar=nchar, divisions=make_divisions(m))


def _engine(**mcmc):
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    return Engine(_synthetic_dataset(),
                  [DivisionSettings(nst="6", rates="gamma")],
                  mcmc=McmcSettings(**{**SYNTH, **mcmc}), device="cpu")


def _carried_error(eng, states) -> float:
    """Largest |carried - recomputed| of this rank's lnL and lnP."""
    from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
    fresh = eng.score({k: v for k, v in states.items()
                       if k not in SCORE_KEYS})
    return max(float((fresh[k] - states[k]).abs().max())
               for k in ("lnL", "lnP"))


def _rank_library(rank, world, port):
    """Rank ``rank``'s part of the library checks; returns its record."""
    from mrbayes_tpu_torch.parallel import mesh as PM
    w = PM.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                            timeout=60)
    out = {"backend": w.backend}
    # 2 runs x 4 chains: a run a rank, the swaps local
    eng = _engine()
    mesh = PM.auto_mesh(eng.mcmc.n_chains_total, ["cpu"])
    out["mesh"] = mesh.shape
    states, bk = PM.shard_chains(eng, mesh, *eng.init_chains())
    out["slice"] = list(eng.chain_slice)
    host, _, _ = PM.gather_to_host(states, bk)
    out["start_lnL"] = host["lnL"].tolist()
    out["start_lnP"] = host["lnP"].tolist()
    c0 = w.collectives
    states, bk = eng.run_block(states, bk, 60)
    out["block_collectives_local"] = w.collectives - c0
    out["carried_err"] = _carried_error(eng, states)
    host, hbk, _ = PM.gather_to_host(states, bk)
    bk = PM.replicate_bookkeeping(bk, hbk, host["temp_id"])
    out.update(lnL=host["lnL"].tolist(), temp_id=host["temp_id"].tolist(),
               gen=bk["gen"], swap_tries=int(hbk["swap_tries"].sum()),
               temp_id_device=bk["temp_id"].tolist())
    # ranks propose apart: one branch-length move from chain 0's state on
    # every chain
    m = [mv.name for mv in eng.moves].index("blen_mult")
    same = {k: v[:1].expand_as(v).clone() for k, v in states.items()
            if k not in ("lnL", "lnP", "lnP_tree", "lnP_par")}
    new, _ = eng.moves[m].fn(bk["rng"], same, bk["tuning"][:, m])
    out["blen_proposals"] = PM.all_gather(new["blen"]).tolist()
    # 1 run x 4 chains: E gathered every swap generation
    eng1 = _engine(nruns=1)
    states, bk = PM.shard_chains(eng1, PM.auto_mesh(4, ["cpu"]),
                                 *eng1.init_chains())
    swaps = []
    for _ in range(5):
        host0, _, _ = PM.gather_to_host(states, bk)
        swap_state = bk["rng_swap"].get_state().tolist()
        c0 = w.collectives
        states, bk = eng1.run_block(states, bk, 1)
        ncoll = w.collectives - c0
        host1, hbk1, _ = PM.gather_to_host(states, bk)
        swaps.append({"lnL": host1["lnL"].tolist(),
                      "lnP": host1["lnP"].tolist(),
                      "tid0": host0["temp_id"].tolist(),
                      "tid1": host1["temp_id"].tolist(),
                      "device_tid1": bk["temp_id"].tolist(),
                      "swap_tries": hbk1["swap_tries"].tolist(),
                      "swap_accepts": hbk1["swap_accepts"].tolist(),
                      "rng_swap": swap_state, "collectives": ncoll})
    out["swaps"] = swaps
    out["carried_err_gathered"] = _carried_error(eng1, states)
    # per-chain moves: each generation's move counts of every chain
    eng2 = _engine(per_chain_moves=True)
    states, bk = PM.shard_chains(eng2, PM.auto_mesh(8, ["cpu"]),
                                 *eng2.init_chains())
    tries = []
    for _ in range(4):
        states, bk = eng2.run_block(states, bk, 1)
        _, hbk, _ = PM.gather_to_host(states, bk)
        tries.append(hbk["tries_total"].tolist())
    out["per_chain_tries"] = tries
    PM.shutdown_distributed()
    return out


def _rank_one(port):
    """A world of one through the process group: 30 generations."""
    from mrbayes_tpu_torch.parallel import mesh as PM
    PM.init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu", timeout=60)
    eng = _engine()
    states, bk = PM.shard_chains(eng, PM.auto_mesh(8, ["cpu"]),
                                 *eng.init_chains())
    states, bk = eng.run_block(states, bk, 30)
    PM.shutdown_distributed()
    return _exact(states, bk)


def _exact(states, bk) -> dict:
    """Every state tensor, ``temp_id``, ``tuning`` and the swap matrices
    as exact Python values (float32 converts to float exactly)."""
    keys = sorted(k for k in states if not k.startswith("eig"))
    return {**{k: states[k].tolist() for k in keys},
            **{k: bk[k].tolist() for k in ("temp_id", "tuning",
                                            "swap_tries", "swap_accepts")}}


def _rank_cli(rank, world, port, script, fail_at):
    """The CLI's main on this rank; returns each run's generations.  With
    ``fail_at`` > 0 rank 1 raises in its ``fail_at``-th block."""
    from mrbayes_tpu_torch import cli
    from mrbayes_tpu_torch.mcmc import run as R
    from mrbayes_tpu_torch.mcmc.engine import Engine
    runners = []
    orig_run, orig_block = R.McmcRunner.run, Engine.run_block

    def run(self):
        runners.append(self)
        return orig_run(self)

    calls = [0]

    def run_block(self, *a, **k):
        calls[0] += 1
        if rank == 1 and calls[0] == fail_at:
            raise RuntimeError("rank 1 fails on purpose")
        return orig_block(self, *a, **k)

    R.McmcRunner.run = run
    Engine.run_block = run_block
    rc = cli.main(["--coordinator", f"127.0.0.1:{port}", "--nprocs",
                   str(world), "--procid", str(rank), "--device", "cpu",
                   script])
    return {"rc": rc, "generations": [r.generations for r in runners],
            "gens": [int(r.final_bk["gen"]) for r in runners]}


def _worker(argv):
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    mode = argv[0]
    if mode == "library":
        res = _rank_library(int(argv[1]), int(argv[2]), argv[3])
    elif mode == "one":
        res = _rank_one(argv[1])
    else:
        os.chdir(argv[4])
        res = _rank_cli(int(argv[1]), int(argv[2]), argv[3], argv[5],
                        int(argv[6]))
    print("RESULT " + json.dumps(res), flush=True)


# ---------------------------------------------------------------- launch

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(arg_lists, cwd=ROOT, env=None):
    """Start one process a rank, wait for all under ``TIMEOUT`` (killing
    every one on overrun); [(returncode, output, result or None)]."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *map(str, args)],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for args in arg_lists]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for p, out in zip(procs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        res.append((p.returncode, out,
                    json.loads(lines[-1][7:]) if lines else None))
    return res


@pytest.fixture(scope="module")
def library():
    """Two library ranks and a world of one, started together."""
    port, port1 = _free_port(), _free_port()
    res = _launch([("library", 0, 2, port), ("library", 1, 2, port),
                   ("one", port1)])
    for rc, out, r in res:
        assert rc == 0 and r is not None, out[-4000:]
    return [r for _, _, r in res]


def test_two_ranks_run_a_block(library):
    """test_multihost.py:28 / test_parallel.py:25: 2 runs x 4 chains over
    two ranks, 60 generations."""
    r0, r1, _ = library
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["mesh"] == {"chains": 2, "sites": 1}
    assert (r0["slice"], r1["slice"]) == ([0, 4], [4, 8])
    for r in (r0, r1):
        lnl = np.asarray(r["lnL"])
        assert lnl.shape == (8,) and np.isfinite(lnl).all()
        assert r["gen"] == 60
        tid = np.asarray(r["temp_id"])
        assert sorted(tid[:4]) == [0, 1, 2, 3] == sorted(tid[4:])
        assert r["swap_tries"] > 0
        # a run a rank: the swaps need no collective
        assert r["block_collectives_local"] == 0
        assert r["carried_err"] < 1e-2 and r["carried_err_gathered"] < 1e-2
        # the gathered temp_id is back on the device, alike on every rank
        assert r["temp_id_device"] == r["temp_id"]
    assert r0["lnL"] == r1["lnL"] and r0["temp_id"] == r1["temp_id"]


def test_start_scores_equal_one_process_and_jax(library):
    r0, r1, _ = library
    eng = _engine()
    states, _ = eng.init_chains()
    for r in (r0, r1):
        np.testing.assert_allclose(r["start_lnL"], states["lnL"].numpy(),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(r["start_lnP"], states["lnP"].numpy(),
                                   rtol=1e-6, atol=0)
    # the JAX package's Engine.init_chains on the same seed
    import jax  # noqa: F401  (configured by conftest)
    from mrbayes_tpu.data import DataSet as JDataSet
    from mrbayes_tpu.data import make_divisions as j_make_divisions
    from mrbayes_tpu.mcmc.engine import Engine as JEngine
    from mrbayes_tpu.mcmc.settings import DivisionSettings as JDiv
    from mrbayes_tpu.mcmc.settings import McmcSettings as JMcmc
    from mrbayes_tpu.nexus.datatypes import DataType as JDataType
    from mrbayes_tpu.nexus.datatypes import FormatInfo as JFormatInfo
    from mrbayes_tpu.nexus.parser import CharacterMatrix as JMatrix
    rng = np.random.default_rng(7)
    codes = (1 << rng.integers(0, 4, size=(6, 48))).astype(np.uint32)
    m = JMatrix(taxa=[f"t{i}" for i in range(6)], nchar=48,
                fmt=JFormatInfo(datatype=JDataType.DNA), codes=codes,
                col_datatype=[JDataType.DNA] * 48)
    jeng = JEngine(JDataSet(taxa=m.taxa, nchar=48,
                            divisions=j_make_divisions(m)),
                   [JDiv(nst="6", rates="gamma")], mcmc=JMcmc(**SYNTH))
    jst, _ = jeng.init_chains()
    np.testing.assert_allclose(r0["start_lnL"], np.asarray(jst["lnL"]),
                               atol=5e-2, rtol=0)
    np.testing.assert_allclose(r0["start_lnP"], np.asarray(jst["lnP"]),
                               atol=1e-4, rtol=0)


def test_world_of_one_is_bit_for_bit(library):
    one = library[2]
    eng = _engine()
    states, bk = eng.run_block(*eng.init_chains(), 30)
    assert one == json.loads(json.dumps(_exact(states, bk)))


def test_gathered_swap_equals_one_process(library):
    """1 run x 4 chains, chains 0-1 on rank 0 and 2-3 on rank 1: every
    generation's swap, taken from E gathered across the ranks, against
    the one-process ``_swap_step`` on the same E, ``temp_id`` and draws."""
    r0, r1, _ = library
    eng = _engine(nruns=1)
    tries = torch.zeros(1, 4, 4, dtype=torch.int32)
    accepts = torch.zeros_like(tries)
    for s0, s1 in zip(r0["swaps"], r1["swaps"]):
        assert s0["collectives"] == s1["collectives"] == 1
        for key in ("tid1", "swap_tries", "swap_accepts", "lnL", "lnP"):
            assert s0[key] == s1[key]
        assert s0["device_tid1"] == s0["tid1"] == s1["device_tid1"]
        gen = torch.Generator()
        gen.set_state(torch.tensor(s0["rng_swap"], dtype=torch.uint8))
        si, sj, su = eng._swap_draws(gen, 1)
        E = torch.tensor(s0["lnL"]) + torch.tensor(s0["lnP"])
        tid, (lo, hi, acc) = eng._swap_step((si[0], sj[0], su[0]), E,
                                            torch.tensor(s0["tid0"]))
        assert tid.tolist() == s0["tid1"]
        tries, accepts = eng._accumulate_swap_stats(
            tries, accepts, lo[None], hi[None], acc[None])
        assert tries.tolist() == s0["swap_tries"]
        assert accepts.tolist() == s0["swap_accepts"]
    assert sorted(r0["swaps"][-1]["tid1"]) == [0, 1, 2, 3]


def test_ranks_do_not_propose_in_lockstep(library):
    prop = np.asarray(library[0]["blen_proposals"])      # [rank, 4, n]
    assert prop.shape[:2] == (2, 4)
    assert not np.allclose(prop[0], prop[1])
    # and chains of one rank propose apart too
    assert not np.allclose(prop[0, 0], prop[0, 1])


def test_per_chain_moves_are_the_one_process_draws(library):
    eng = _engine(per_chain_moves=True)
    states, bk = eng.init_chains()
    for got in library[0]["per_chain_tries"]:
        states, bk = eng.run_block(states, bk, 1)
        assert got == bk["tries_total"].tolist()
    assert library[0]["per_chain_tries"] == library[1]["per_chain_tries"]


# ------------------------------------------------------------------ CLI

DRIVE = """#NEXUS
begin mrbayes;
    set autoclose=yes nowarnings=yes seed=21 swapseed=22;
    execute {primates};
    lset nst=2 rates=gamma;
    {pre}
    mcmc ngen={ngen} nruns=2 nchains=2 samplefreq=40 printfreq=120
         diagnfreq={diagnfreq} checkfreq=120 file=dist{more};
    {summaries}
end;
"""


def _drive(tmp, name, ngen=120, diagnfreq=120, more="",
           summaries="sumt;\n    sump;", pre=""):
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(DRIVE.format(primates=PRIMATES, ngen=ngen,
                             diagnfreq=diagnfreq, more=more,
                             summaries=summaries, pre=pre))
    return path


def _cli(tmp, script, fail_at=0, env=None, dirs=None):
    """Two CLI ranks on ``script``, working in ``tmp`` (or in ``dirs``, a
    directory a rank)."""
    port = _free_port()
    return _launch([("cli", pid, 2, port, (dirs or [tmp, tmp])[pid], script,
                     fail_at) for pid in range(2)], env=env)


def test_cli_two_ranks_write_the_file_set_once(tmp_path):
    """test_multihost.py:78: the CLI under two ranks; rank 0 writes every
    file and runs sumt and sump, rank 1 writes and prints nothing (it
    works in a directory of its own, which stays empty)."""
    tmp = str(tmp_path)
    rank1 = tmp_path / "rank1"
    rank1.mkdir()
    report = "report siterates=yes;"
    res = _cli(tmp, _drive(tmp, "drive.nex", pre=report),
               dirs=[tmp, str(rank1)])
    for rc, out, r in res:
        assert rc == 0 and r is not None and r["rc"] == 0, out[-4000:]
    out0, out1 = res[0][1], res[1][1]
    for suffix in ("run1.p", "run2.p", "run1.t", "run2.t", "ckp",
                   "mcmc", "con.tre", "pstat", "trprobs"):
        assert (tmp_path / f"dist.{suffix}").exists(), suffix
    assert "Sharding over mesh {'chains': 2, 'sites': 1} (2 process(es), " \
        "backend gloo)" in out0
    assert "Consensus" in out0 and "Consensus" not in out1
    assert "Executing" not in out1 and not os.listdir(rank1)
    assert res[0][2]["gens"] == res[1][2]["gens"] == [120]
    # the .p header and generation-0 row equal a one-process run's, the
    # site rates of the report columns included (each run's from the rank
    # that holds its cold chain)
    from mrbayes_tpu_torch.cli import Interpreter
    one = tmp_path / "one"
    one.mkdir()
    cwd = os.getcwd()
    os.chdir(one)
    try:
        Interpreter(log=lambda m: None, device="cpu").execute_file(
            _drive(str(one), "drive.nex", summaries="", pre=report))
    finally:
        os.chdir(cwd)
    for r in (1, 2):
        two = (tmp_path / f"dist.run{r}.p").read_text().splitlines()
        ref = (one / f"dist.run{r}.p").read_text().splitlines()
        assert two[:3] == ref[:3] and "r(898)" in two[1]
        assert len(two) == len(ref) == 6


def test_cli_stoprule_stops_both_ranks_together(tmp_path):
    tmp = str(tmp_path)
    res = _cli(tmp, _drive(tmp, "stop.nex", ngen=4000, diagnfreq=40,
                           more=" stoprule=yes stopval=0.9", summaries=""))
    for rc, out, r in res:
        assert rc == 0 and r is not None, out[-4000:]
    assert "Analysis stopped: convergence criterion reached" in res[0][1]
    g0, g1 = res[0][2]["gens"], res[1][2]["gens"]
    assert g0 == g1 and g0[0] < 4000


def test_cli_append_resumes_across_ranks(tmp_path):
    tmp = str(tmp_path)
    res = _cli(tmp, _drive(tmp, "first.nex", summaries=""))
    assert all(rc == 0 for rc, _, _ in res), res[0][1][-4000:]
    res = _cli(tmp, _drive(tmp, "again.nex", ngen=240,
                           more=" append=yes", summaries=""))
    for rc, out, r in res:
        assert rc == 0 and r is not None, out[-4000:]
    assert "Resuming from checkpoint at generation 120" in res[0][1]
    assert res[0][2]["generations"] == res[1][2]["generations"] == [120]
    assert res[0][2]["gens"] == [240]
    rows = [ln.split("\t")[0] for ln in
            (tmp_path / "dist.run1.p").read_text().splitlines()
            if ln[:1].isdigit()]
    assert rows == ["0", "40", "80", "120", "160", "200", "240"]


def test_a_failing_rank_ends_both(tmp_path):
    tmp = str(tmp_path)
    res = _cli(tmp, _drive(tmp, "fail.nex", ngen=400, summaries=""),
               fail_at=2, env={"MB_DIST_TIMEOUT": "30"})
    (rc0, out0, _), (rc1, out1, _) = res
    assert rc1 != 0 and "rank 1 fails on purpose" in out1
    assert rc0 != 0, out0[-4000:]


if __name__ == "__main__":
    _worker(sys.argv[1:])
