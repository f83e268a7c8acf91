"""The port stands alone: importing ``mrbayes_tpu_torch`` (the engine, the
CLI, the run driver, the summaries, the native tree reader and the
envelope run) and running CPU ``Engine`` blocks, single-division,
partitioned through the multiwalk wiring, sharded over the ``sites``
mesh axis (``parallel.mesh``, ``parallel.dryrun``), on a clock tree
(``mcmc.clock``, test2's relaxed clock), under the protein and codon
models (``models.aa_models``, ``models.codes``, the S > 8 eigensolver
``ops.eigh_cuda``; codon M3 and M10 with ``models.rates.betainc``) and on
kim.nex's stem doublets and unlinked trees, and a world of one over
``torch.distributed`` (``parallel.mesh``'s chains axis), loads neither JAX nor any module of the JAX package
(``mrbayes_tpu``), and ``chip_smoke.py`` imports neither.  Checked in a
fresh interpreter, since this test process has JAX loaded already.  The
new entry points run on CUDA unless given the CPU: an engine under a
protein or codon model raises without a CUDA device, and the eigensolver's
kernel wrapper refuses a CPU tensor."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import mrbayes_tpu_torch
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.mcmc.engine import Engine
from mrbayes_tpu_torch.mcmc.settings import DivisionSettings, McmcSettings
from mrbayes_tpu_torch.nexus.parser import read_nexus_file
nf = read_nexus_file(sys.argv[1])
ds = DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
             divisions=make_divisions(nf.matrix))
eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
             mcmc=McmcSettings(nruns=1, nchains=2, seed=1), device="cpu")
states, bk = eng.init_chains()
states, bk = eng.run_block(states, bk, 3)
assert bk["gen"] == 3
# the partitioned path through the CLI, the driver and the summaries
import mrbayes_tpu_torch.envelope
import mrbayes_tpu_torch.native
import mrbayes_tpu_torch.summarize.fast_t
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.mcmc.run import McmcRunner
from mrbayes_tpu_torch.summarize.sump import sump
from mrbayes_tpu_torch.summarize.sumt import sumt
it = Interpreter(log=lambda m: None, device="cpu", multiwalk=True)
for line in ["execute " + sys.argv[1], "partition p = 2: 1-400, 401-.",
             "set partition=p", "lset nst=mixed rates=invgamma",
             "prset ratepr=variable",
             "mcmcp nruns=1 nchains=2 ngen=3 samplefreq=3"]:
    it.run_line(line)
eng = it.build_engine()
assert eng._multiwalk_pruners
states, bk = eng.run_block(*eng.init_chains(), 3)
# the same engine sharded over the sites axis
import mrbayes_tpu_torch.parallel.dryrun
from mrbayes_tpu_torch.parallel.mesh import make_mesh, shard_engine_data
shard_engine_data(eng, make_mesh(1, 2, ["cpu"] * 2))
states, bk = eng.run_block(*eng.init_chains(), 3)
# the chains axis over processes: a world of one through gloo, its block
# gathered as the ranks of a launch over processes gather it
import socket
from mrbayes_tpu_torch.parallel import mesh as PM
sock = socket.socket()
sock.bind(("127.0.0.1", 0))
port = sock.getsockname()[1]
sock.close()
PM.init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu", timeout=60)
eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
             mcmc=McmcSettings(nruns=1, nchains=2, seed=1), device="cpu")
states, bk = PM.shard_chains(eng, PM.auto_mesh(2, ["cpu"]),
                             *eng.init_chains())
states, bk = eng.run_block(states, bk, 3)
host, host_bk, _ = PM.gather_to_host(states, bk)
assert host["lnL"].shape == (2,) and PM.world().backend == "gloo"
PM.shutdown_distributed()
# a clock engine: test2's IGR relaxed clock, with its rooted tree
it = Interpreter(log=lambda m: None, device="cpu")
for line in ["execute " + sys.argv[1], "partition p = 2: 1-400, 401-.",
             "set partition=p", "lset nst=mixed rates=invgamma",
             "prset brlenspr=clock:uniform clockratepr=exp(1) "
             "clockvarpr=igr", "mcmcp nruns=1 nchains=2"]:
    it.run_line(line)
eng = it.build_engine()
states, bk = eng.run_block(*eng.init_chains(), 3)
assert "age" in states and eng.extract_tree(states, 0).rooted
# protein (aamodelpr=mixed and protein GTR) and codon (NY98) engines
import os
import mrbayes_tpu_torch.models.aa_models
import mrbayes_tpu_torch.models.codes
import mrbayes_tpu_torch.ops.eigh_cuda
examples = os.path.dirname(sys.argv[1])
# kim's stem doublets and unlinked trees, and codon M3 and M10
for data, lines in [
        ("avian_ovomucoids.nex", ["prset aamodelpr=mixed"]),
        ("avian_ovomucoids.nex", ["prset aamodelpr=fixed(gtr)"]),
        ("replicase.nex", ["lset nucmodel=codon omegavar=ny98"]),
        ("replicase.nex", ["lset nucmodel=codon omegavar=m3"]),
        ("replicase.nex", ["lset nucmodel=codon omegavar=m10"]),
        ("kim.nex", ["set partition=by_gene_and_struct",
                     "lset applyto=(1) nucmodel=doublet nst=6"]),
        ("kim.nex", ["set partition=by_gene",
                     "unlink topology=(all) brlens=(all)"])]:
    it = Interpreter(log=lambda m: None, device="cpu")
    for ln in ["execute " + os.path.join(examples, data), *lines,
               "mcmcp nruns=1 nchains=2"]:
        it.run_line(ln)
    eng = it.build_engine()
    states, bk = eng.run_block(*eng.init_chains(), 3)
print(" ".join(sorted(sys.modules)))
"""


def _is_foreign(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "mrbayes_tpu")


def test_port_loads_no_jax_module():
    from conftest import example
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, example("primates.nex")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})   # small tensors
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = out.stdout.split()
    assert "mrbayes_tpu_torch" in loaded
    assert not [m for m in loaded if _is_foreign(m)]


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax_module():
    """Every import statement of the package and of chip_smoke.py, including
    those inside functions that the probe above does not reach."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mrbayes_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    found = {(os.path.relpath(f, ROOT), m) for f in files
             for m in _imports(f) if _is_foreign(m)}
    assert not found, sorted(found)


def test_new_entry_points_default_to_cuda():
    import pytest
    import torch
    from conftest import example
    from mrbayes_tpu_torch.data import DataSet, make_divisions
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import DivisionSettings, Prior
    from mrbayes_tpu_torch.nexus.parser import read_nexus_file
    from mrbayes_tpu_torch.ops.eigh_cuda import eigh_cuda
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        eigh_cuda(torch.eye(20, dtype=torch.float64).expand(2, 20, 20)
                  .contiguous())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name, kw in (("avian_ovomucoids.nex",
                      dict(aamodelpr=Prior("mixed", ()))),
                     ("replicase.nex",
                      dict(nucmodel="codon", omegavar="ny98"))):
        nf = read_nexus_file(example(name))
        ds = DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                     divisions=make_divisions(nf.matrix))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(ds, [DivisionSettings(**kw)])
