"""The port stands alone: importing ``mrbayes_tpu_torch`` (the engine, the
CLI, the run driver, the summaries, the native tree reader and the
envelope run) and running CPU ``Engine`` blocks, single-division,
partitioned through the multiwalk wiring, sharded over the ``sites``
mesh axis (``parallel.mesh``, ``parallel.dryrun``) and on a clock tree
(``mcmc.clock``, test2's relaxed clock), loads neither JAX nor any
module of the JAX package (``mrbayes_tpu``), and ``chip_smoke.py``
imports neither.  Checked in a
fresh interpreter, since this test process has JAX loaded already."""
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
