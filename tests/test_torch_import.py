"""The PyTorch port stands alone: importing it loads neither JAX nor any
module of the JAX package, and no source file of the port (nor
chip_smoke.py) names them in an import.  Every ported module names its
counterpart in the JAX package on its first line."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tidb_tpu_torch"
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for p in PORT.rglob("*.py")) + ["chip_smoke.py"]

# `tidb_tpu` followed by "." or a word boundary: `tidb_tpu_torch` is not
# a match, `tidb_tpu.copr` and `from tidb_tpu import x` are
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|tidb_tpu(?:\.|\b(?!_)))",
    re.MULTILINE)
PROVENANCE = re.compile(r"^# ported from (tidb_tpu/\S+\.py) @ [0-9a-f]{7,}$")


# the join slice's modules: each among the sources checked below
JOIN_MODULES = ["tidb_tpu_torch/copr/join.py",
                "tidb_tpu_torch/parallel/exchange.py",
                "tidb_tpu_torch/parallel/shuffle.py",
                "tidb_tpu_torch/planner/join_reorder.py",
                "tidb_tpu_torch/planner/cardinality.py"]


# the store slice's modules, the native engine's loader among them
STORE_MODULES = ["tidb_tpu_torch/store/kv.py",
                 "tidb_tpu_torch/store/codec.py",
                 "tidb_tpu_torch/store/gcworker.py",
                 "tidb_tpu_torch/session/codec_io.py",
                 "tidb_tpu_torch/session/autoid.py",
                 "tidb_tpu_torch/session/meta.py",
                 "tidb_tpu_torch/ddl/mdl.py",
                 "tidb_tpu_torch/ddl/jobs.py",
                 "tidb_tpu_torch/ddl/election.py",
                 "tidb_tpu_torch/ddl/owner.py"]


# the SELECT surface's modules: partition pruning copied, the evaluator
# and the rollup program grown
SELECT_MODULES = ["tidb_tpu_torch/planner/partition_prune.py",
                  "tidb_tpu_torch/expr/compile.py",
                  "tidb_tpu_torch/copr/exec.py"]


# windows and statistics: the window program, the cost model of the
# high-NDV strategy choice and the stats package
WINDOW_STATS_MODULES = ["tidb_tpu_torch/parallel/window.py",
                        "tidb_tpu_torch/parallel/topology.py",
                        "tidb_tpu_torch/analysis/__init__.py",
                        "tidb_tpu_torch/analysis/contracts.py",
                        "tidb_tpu_torch/analysis/copcost.py",
                        "tidb_tpu_torch/analysis/calibrate.py",
                        "tidb_tpu_torch/analysis/compilekey.py",
                        "tidb_tpu_torch/stats/__init__.py",
                        "tidb_tpu_torch/stats/build.py",
                        "tidb_tpu_torch/stats/histogram.py",
                        "tidb_tpu_torch/stats/sketch.py",
                        "tidb_tpu_torch/stats/handle.py"]


# the server slice's modules: the wire protocol, the status API, the
# command line, users and grants, the plan cache and bindings
SERVER_MODULES = ["tidb_tpu_torch/__main__.py",
                  "tidb_tpu_torch/config.py",
                  "tidb_tpu_torch/utils/auth.py",
                  "tidb_tpu_torch/utils/watch.py",
                  "tidb_tpu_torch/utils/metrics.py",
                  "tidb_tpu_torch/utils/stmtsummary.py",
                  "tidb_tpu_torch/privilege/__init__.py",
                  "tidb_tpu_torch/privilege/manager.py",
                  "tidb_tpu_torch/sql/bind.py",
                  "tidb_tpu_torch/planner/plan_cache.py",
                  "tidb_tpu_torch/planner/bindinfo.py",
                  "tidb_tpu_torch/plugin/__init__.py",
                  "tidb_tpu_torch/server/__init__.py",
                  "tidb_tpu_torch/server/packet.py",
                  "tidb_tpu_torch/server/mysql_server.py",
                  "tidb_tpu_torch/server/status.py",
                  "tidb_tpu_torch/server/client.py",
                  "tidb_tpu_torch/testing/mysql_client.py"]


# the host aggregation and the client's resilience: the fault plane,
# the native host primitives, the host engines, the streamed and
# resilient client and the remote store processes
RESILIENCE_MODULES = ["tidb_tpu_torch/faults/__init__.py",
                      "tidb_tpu_torch/faults/plan.py",
                      "tidb_tpu_torch/faults/breaker.py",
                      "tidb_tpu_torch/copr/nativeops.py",
                      "tidb_tpu_torch/copr/hostagg.py",
                      "tidb_tpu_torch/store/columnar.py",
                      "tidb_tpu_torch/store/client.py",
                      "tidb_tpu_torch/store/rpc.py",
                      "tidb_tpu_torch/store/server.py",
                      "tidb_tpu_torch/store/remote.py"]


# admission and programs: the device scheduler, resource control, the
# program cache, the memory ledger of obs/, and the modules they grow
SCHED_MODULES = ["tidb_tpu_torch/sched/__init__.py",
                 "tidb_tpu_torch/sched/task.py",
                 "tidb_tpu_torch/sched/scheduler.py",
                 "tidb_tpu_torch/rc/__init__.py",
                 "tidb_tpu_torch/rc/bucket.py",
                 "tidb_tpu_torch/rc/pricing.py",
                 "tidb_tpu_torch/rc/runaway.py",
                 "tidb_tpu_torch/rc/controller.py",
                 "tidb_tpu_torch/compilecache/__init__.py",
                 "tidb_tpu_torch/compilecache/cache.py",
                 "tidb_tpu_torch/compilecache/manifest.py",
                 "tidb_tpu_torch/compilecache/warmup.py",
                 "tidb_tpu_torch/obs/__init__.py",
                 "tidb_tpu_torch/obs/hbm.py",
                 "tidb_tpu_torch/utils/filelock.py",
                 "tidb_tpu_torch/analysis/compilekey.py",
                 "tidb_tpu_torch/analysis/contracts.py",
                 "tidb_tpu_torch/analysis/copcost.py",
                 "tidb_tpu_torch/analysis/calibrate.py",
                 "tidb_tpu_torch/parallel/spmd.py"]


# the statement's observability: the spans, the flight recorder, the
# roofline and the rest of the memory plane, the runtime statistics,
# the statement summary, telemetry, the JSON functions, and the modules
# they grow
OBS_MODULES = ["tidb_tpu_torch/obs/__init__.py",
               "tidb_tpu_torch/obs/trace.py",
               "tidb_tpu_torch/obs/recorder.py",
               "tidb_tpu_torch/obs/roofline.py",
               "tidb_tpu_torch/obs/hbm.py",
               "tidb_tpu_torch/utils/tracing.py",
               "tidb_tpu_torch/utils/execdetails.py",
               "tidb_tpu_torch/utils/stmtsummary.py",
               "tidb_tpu_torch/utils/telemetry.py",
               "tidb_tpu_torch/utils/jsonfns.py",
               "tidb_tpu_torch/sched/task.py",
               "tidb_tpu_torch/sched/scheduler.py",
               "tidb_tpu_torch/store/client.py",
               "tidb_tpu_torch/faults/plan.py",
               "tidb_tpu_torch/expr/lower_strings.py",
               "tidb_tpu_torch/planner/build.py",
               "tidb_tpu_torch/executor/physical.py",
               "tidb_tpu_torch/server/status.py",
               "tidb_tpu_torch/session/session.py"]


# the plan-time gates and buffer lifetime: the analysis passes, the
# declared host view, and the modules they grow
GATES_MODULES = ["tidb_tpu_torch/analysis/__init__.py",
                 "tidb_tpu_torch/analysis/shardflow.py",
                 "tidb_tpu_torch/analysis/valueflow.py",
                 "tidb_tpu_torch/analysis/lifetime.py",
                 "tidb_tpu_torch/analysis/lint.py",
                 "tidb_tpu_torch/analysis/contracts.py",
                 "tidb_tpu_torch/analysis/copcost.py",
                 "tidb_tpu_torch/analysis/compilekey.py",
                 "tidb_tpu_torch/parallel/topology.py",
                 "tidb_tpu_torch/parallel/spmd.py",
                 "tidb_tpu_torch/executor/plan.py",
                 "tidb_tpu_torch/stats/handle.py",
                 "tidb_tpu_torch/sched/task.py",
                 "tidb_tpu_torch/sched/scheduler.py",
                 "tidb_tpu_torch/store/columnar.py",
                 "tidb_tpu_torch/store/client.py",
                 "tidb_tpu_torch/obs/hbm.py",
                 "tidb_tpu_torch/session/session.py"]


# the coordination plane and the background workers: pd/, the timers,
# TTL, DXF, the index advisor, the extension points, and the modules
# they grow
PD_MODULES = ["tidb_tpu_torch/pd/__init__.py",
              "tidb_tpu_torch/pd/store.py",
              "tidb_tpu_torch/pd/lease.py",
              "tidb_tpu_torch/pd/quota.py",
              "tidb_tpu_torch/pd/registry.py",
              "tidb_tpu_torch/pd/coordinator.py",
              "tidb_tpu_torch/timer/__init__.py",
              "tidb_tpu_torch/ttl/__init__.py",
              "tidb_tpu_torch/dxf/__init__.py",
              "tidb_tpu_torch/dxf/tasks.py",
              "tidb_tpu_torch/dxf/balancer.py",
              "tidb_tpu_torch/planner/advisor.py",
              "tidb_tpu_torch/extension/__init__.py",
              "tidb_tpu_torch/compilecache/cache.py",
              "tidb_tpu_torch/compilecache/manifest.py",
              "tidb_tpu_torch/ddl/owner.py",
              "tidb_tpu_torch/stats/handle.py",
              "tidb_tpu_torch/server/status.py",
              "tidb_tpu_torch/session/session.py"]


# the ecosystem tools' and the cascades planner's slice: tools/,
# planner/cascades/, the micro-benchmarks, and the modules they grow
TOOLS_MODULES = ["tidb_tpu_torch/tools/__init__.py",
                 "tidb_tpu_torch/tools/external_sort.py",
                 "tidb_tpu_torch/tools/lightning.py",
                 "tidb_tpu_torch/tools/br.py",
                 "tidb_tpu_torch/tools/dump.py",
                 "tidb_tpu_torch/planner/cascades/__init__.py",
                 "tidb_tpu_torch/planner/cascades/cost.py",
                 "tidb_tpu_torch/planner/cascades/memo.py",
                 "tidb_tpu_torch/planner/cascades/search.py",
                 "tidb_tpu_torch/testing/bench_host.py",
                 "tidb_tpu_torch/testing/bench_kv.py",
                 "tidb_tpu_torch/session/session.py",
                 "tidb_tpu_torch/__main__.py"]


# resource control end to end and the chaos stress harness: the shim,
# the harness, and the modules they grow
RESOURCE_MODULES = ["tidb_tpu_torch/utils/resourcegroup.py",
                    "tidb_tpu_torch/testing/stress.py",
                    "tidb_tpu_torch/rc/__init__.py",
                    "tidb_tpu_torch/server/status.py",
                    "tidb_tpu_torch/session/session.py"]


@pytest.mark.parametrize("path", JOIN_MODULES + STORE_MODULES
                         + SELECT_MODULES + WINDOW_STATS_MODULES
                         + SERVER_MODULES + RESILIENCE_MODULES
                         + SCHED_MODULES + OBS_MODULES + GATES_MODULES
                         + PD_MODULES + TOOLS_MODULES + RESOURCE_MODULES)
def test_join_modules_are_checked(path):
    assert path in SOURCES


@pytest.mark.parametrize("line,hit", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jax import lax", True), ("import tidb_tpu", True),
    ("from tidb_tpu.copr import dag", True), ("import tidb_tpu.copr", True),
    ("from tidb_tpu import copr", True), ("  import jaxlib", True),
    ("import tidb_tpu_torch", False), ("from tidb_tpu_torch import x", False),
    ("from tidb_tpu_torch.copr import dag", False), ("import jaxtyping", False),
    ("# import jax", False), ("x = 'import jax'", False),
])
def test_forbidden_import_pattern(line, hit):
    assert bool(FORBIDDEN.search(line)) is hit


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_neither_jax_nor_tidb_tpu(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.findall(text), path


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.startswith("tidb_tpu_torch/")
                                  and not p.endswith("__init__.py")
                                  and p != "tidb_tpu_torch/device.py"])
def test_ported_module_names_its_counterpart(path):
    first = (ROOT / path).read_text().splitlines()[0]
    m = PROVENANCE.match(first)
    assert m, f"{path}: first line {first!r}"
    assert (ROOT / m.group(1)).exists(), m.group(1)


def test_window_stats_modules_load_no_jax():
    """The modules of the windows-and-statistics slice, imported one by
    one in a fresh interpreter, each leave jax and tidb_tpu out of
    sys.modules."""
    mods = [p[:-3].replace("/", ".").removesuffix(".__init__")
            for p in WINDOW_STATS_MODULES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "    bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "                 or k.startswith(('jax.', 'jaxlib'))\n"
        "                 or k == 'tidb_tpu' or k.startswith('tidb_tpu.'))\n"
        "    print(m, bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split(" ", 1)[0] for ln in lines] == mods
    assert all(ln.split(" ", 1)[1] == "[]" for ln in lines), lines


def _modules_load_no_jax(paths):
    """Import the modules of ``paths`` one by one in a fresh
    interpreter; each must leave jax and tidb_tpu out of sys.modules."""
    mods = [p[:-3].replace("/", ".").removesuffix(".__init__")
            for p in paths]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "    bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "                 or k.startswith(('jax.', 'jaxlib'))\n"
        "                 or k == 'tidb_tpu' or k.startswith('tidb_tpu.'))\n"
        "    print(m, bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split(" ", 1)[0] for ln in lines] == mods
    assert all(ln.split(" ", 1)[1] == "[]" for ln in lines), lines


def test_server_modules_load_no_jax():
    """The server slice's modules, imported one by one in a fresh
    interpreter, each leave jax and tidb_tpu out of sys.modules."""
    _modules_load_no_jax(SERVER_MODULES)


def test_resilience_modules_load_no_jax():
    """The modules of the host aggregation and the client's resilience,
    imported one by one in a fresh interpreter, each leave jax and
    tidb_tpu out of sys.modules."""
    _modules_load_no_jax(RESILIENCE_MODULES)


def test_obs_modules_load_no_jax():
    """The observability slice's modules, imported one by one in a fresh
    interpreter, each leave jax and tidb_tpu out of sys.modules."""
    _modules_load_no_jax(OBS_MODULES)


def test_gates_modules_load_no_jax():
    """The plan-time gates' and buffer lifetime's modules, imported one
    by one in a fresh interpreter, each leave jax and tidb_tpu out of
    sys.modules."""
    _modules_load_no_jax(GATES_MODULES)


def test_pd_modules_load_no_jax():
    """The coordination plane's and the background workers' modules,
    imported one by one in a fresh interpreter, each leave jax and
    tidb_tpu out of sys.modules."""
    _modules_load_no_jax(PD_MODULES)


def test_import_loads_no_jax_module():
    """Import every module of the port in a fresh interpreter; the import
    may bring neither jax nor any tidb_tpu module into sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import tidb_tpu_torch\n"
        "for m in pkgutil.walk_packages(tidb_tpu_torch.__path__,\n"
        "                               'tidb_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in set(sys.modules) - before if k == 'jax'\n"
        "             or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'tidb_tpu' or k.startswith('tidb_tpu.'))\n"
        "n = sum(k.startswith('tidb_tpu_torch') for k in sys.modules)\n"
        "print(n, bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20
    assert bad.strip() == "[]", bad


def _relative_imports(path: str):
    """(line, module path parts, imported names) of every relative import
    in ``path``, its module resolved against the file's package."""
    import ast
    rel = Path(path)
    pkg = list(rel.parts[:-1])
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = pkg[:len(pkg) - node.level + 1]
            mod = base + (node.module.split(".") if node.module else [])
            yield node.lineno, mod, [a.name for a in node.names]


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.startswith("tidb_tpu_torch/")])
def test_relative_imports_resolve_inside_the_port(path):
    """Every relative import of the port, lazy ones inside functions
    too, names a module file of the port (or a name of a package's
    ``__init__``), so an import of a module the port has not ported
    cannot hide until a statement reaches it."""
    import ast
    for line, mod, names in _relative_imports(path):
        target = ROOT.joinpath(*mod)
        assert target.resolve().is_relative_to(PORT.resolve()), \
            f"{path}:{line}: {'.'.join(mod)} lies outside the port"
        if target.with_suffix(".py").exists():
            continue
        init = target / "__init__.py"
        assert init.exists(), f"{path}:{line}: no module {'.'.join(mod)}"
        if mod[-1] == target.name and names != ["*"]:
            defined = {n.id if isinstance(n, ast.Name) else n.name
                       for n in ast.walk(ast.parse(init.read_text()))
                       if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                       or (isinstance(n, ast.Name)
                           and isinstance(n.ctx, ast.Store))}
            defined |= {a.asname or a.name for n in ast.walk(
                ast.parse(init.read_text()))
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names}
            for name in names:
                assert name in defined or (target / name).with_suffix(
                    ".py").exists() or (target / name / "__init__.py"
                                        ).exists(), \
                    f"{path}:{line}: {'.'.join(mod)} has no {name}"


def test_sched_modules_load_no_jax():
    """The admission-and-programs slice's modules (sched/, rc/,
    compilecache/ and the obs/ copy among them), imported one by one in
    a fresh interpreter, each leave jax and tidb_tpu out of
    sys.modules."""
    _modules_load_no_jax(SCHED_MODULES)


def test_tools_modules_load_no_jax():
    """The tools' and the cascades planner's modules, imported one by one
    in a fresh interpreter, each leave jax and tidb_tpu out of
    sys.modules; the micro-benchmarks print nothing at import (the
    helper's output holds only the modules' own lines), so importing
    them runs no benchmark."""
    _modules_load_no_jax(TOOLS_MODULES)


@pytest.mark.parametrize("path", [p for p in TOOLS_MODULES
                                  if "/tools/" in p or "/cascades/" in p
                                  or "/bench_" in p])
def test_tools_modules_name_their_counterpart(path):
    """Every module of the slice, its packages' ``__init__`` included,
    carries its provenance line."""
    first = (ROOT / path).read_text().splitlines()[0]
    m = PROVENANCE.match(first)
    assert m and (ROOT / m.group(1)).exists(), f"{path}: {first!r}"


def test_resource_modules_load_no_jax():
    """The resource-control shim and the stress harness, imported one by
    one in a fresh interpreter, each leave jax and tidb_tpu out of
    sys.modules; importing the harness builds no domain and runs no
    session (the helper's output holds only the modules' own lines)."""
    _modules_load_no_jax(RESOURCE_MODULES)


@pytest.mark.parametrize("path", RESOURCE_MODULES[:2])
def test_resource_modules_name_their_counterpart(path):
    """The shim and the harness carry their provenance lines."""
    first = (ROOT / path).read_text().splitlines()[0]
    m = PROVENANCE.match(first)
    assert m and (ROOT / m.group(1)).exists(), f"{path}: {first!r}"
