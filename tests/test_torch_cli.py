"""``python -m tidb_tpu_torch``: ``serve``, ``import`` and ``dump`` as
processes, and the TOML configuration against the JAX package's.

``serve --device cpu --port 0 --status-port 0`` runs in a subprocess:
its "listening" line names both ports; ``import`` loads a CSV into a
new table over the wire, an aggregate over it answers through the
server, ``dump`` writes it back in both formats, ``/status`` answers,
and SIGINT ends the server with exit code 0.  A config file's
``[variables]`` reach the server's global sysvars; an unknown key, or
an unknown variable, is rejected with the JAX package's error.
``serve`` without ``--device cpu`` exits non-zero here, where torch
finds no GPU, before it binds a port.
"""

import csv
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

from tidb_tpu.config import ConfigError as JConfigError
from tidb_tpu.config import load_config as j_load_config
from tidb_tpu_torch.config import ConfigError, load_config
from tidb_tpu_torch.server.client import Client

ROOT = Path(__file__).resolve().parents[1]
START_S = 120.0          # the server's start, torch's import included
STOP_S = 10.0            # SIGINT to exit
LISTENING = re.compile(r"listening on ([\d.]+):(\d+) \(status :(\d+)\)")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _cli(*args, timeout=START_S):
    return subprocess.run([sys.executable, "-m", "tidb_tpu_torch", *args],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=timeout)


class Served:
    """A ``serve`` subprocess, stopped by SIGINT on exit."""

    def __init__(self, *args):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tidb_tpu_torch", "serve", "--device",
             "cpu", "--port", "0", "--status-port", "0", *args],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        m = LISTENING.search(line)
        if m is None:
            self.proc.kill()
            _out, err = self.proc.communicate(timeout=STOP_S)
            raise AssertionError(f"no listening line: {line!r} {err}")
        self.port, self.status_port = int(m.group(2)), int(m.group(3))

    def stop(self) -> int:
        self.proc.send_signal(signal.SIGINT)
        try:
            self.proc.communicate(timeout=STOP_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise
        return self.proc.returncode


def test_serve_import_dump_and_sigint(tmp_path):
    rows = [(i, f"name{i % 17}", f"{i % 100}.{i % 10}5") for i in range(500)]
    src = tmp_path / "items.csv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "name", "price"])
        w.writerows(rows)
    srv = Served()
    try:
        c = Client("127.0.0.1", srv.port)
        c.execute("create table items (id bigint primary key,"
                  " name varchar(16), price decimal(8,2))")
        out = _cli("import", "--port", str(srv.port), "--table", "items",
                   "--file", str(src), "--batch", "128")
        assert out.returncode == 0, out.stderr
        assert "imported 500 rows into test.items" in out.stdout
        got = c.query("select count(*), sum(price), count(distinct name)"
                      " from items")
        total = sum(int(p.replace(".", "")) for _i, _n, p in rows)
        assert got == [("500", f"{total // 100}.{total % 100:02d}", "17")]
        for fmt in ("csv", "sql"):
            d = tmp_path / fmt
            out = _cli("dump", "--port", str(srv.port), "--out", str(d),
                       "--format", fmt)
            assert out.returncode == 0, out.stderr
            assert "dumped 500 rows from 1 tables" in out.stdout
        with open(tmp_path / "csv" / "test.items.000000000.csv") as f:
            back = list(csv.reader(f))
        assert back[0] == ["id", "name", "price"]
        assert sorted(tuple(r) for r in back[1:]) == sorted(
            (str(i), n, p) for i, n, p in rows)
        sql = (tmp_path / "sql" / "test.items.000000000.sql").read_text()
        assert sql.count("INSERT INTO `items` VALUES") == 3
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.status_port}/status",
                timeout=STOP_S) as r:
            status = json.load(r)
        assert status["connections"] >= 1 and "version" in status
        c.close()
    finally:
        rc = srv.stop()
    assert rc == 0


def test_config_variables_reach_the_server(tmp_path):
    cfg = tmp_path / "server.toml"
    cfg.write_text('host = "127.0.0.1"\n\n[variables]\n'
                   "tidb_mem_quota_query = 123456789\n"
                   "tidb_enable_plan_cache = 0\n\n[log]\n"
                   "slow-threshold-ms = 50\n")
    assert dataclasses.asdict(load_config(str(cfg))) == \
        dataclasses.asdict(j_load_config(str(cfg)))
    srv = Served("--config", str(cfg))
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.status_port}/settings",
                timeout=STOP_S) as r:
            settings = json.load(r)
        assert settings["tidb_mem_quota_query"] == 123456789
        assert settings["tidb_enable_plan_cache"] == 0
    finally:
        assert srv.stop() == 0


BAD_CONFIGS = ['hots = "127.0.0.1"\n', "[variables]\nno_such_variable = 1\n",
               "port = 'x'\n"]


def _config_error(tmp_path, text, load, apply, exc) -> str:
    cfg = tmp_path / "bad.toml"
    cfg.write_text(text)

    class _Dom:                     # the attributes apply_to_domain sets
        def __init__(self):
            self.sysvars = {}
            self.stmt_summary = type("S", (), {})()

    with pytest.raises(exc) as e:
        apply(load(str(cfg)), _Dom())
    return str(e.value)


@pytest.mark.parametrize("text", BAD_CONFIGS)
def test_bad_config_is_rejected_as_the_jax_does(tmp_path, text):
    from tidb_tpu.config import apply_to_domain as j_apply
    from tidb_tpu_torch.config import apply_to_domain
    assert _config_error(tmp_path, text, load_config, apply_to_domain,
                         ConfigError) == \
        _config_error(tmp_path, text, j_load_config, j_apply, JConfigError)


def test_serve_with_a_bad_config_exits_before_binding(tmp_path):
    from tidb_tpu_torch.config import apply_to_domain
    err = _config_error(tmp_path, BAD_CONFIGS[0], load_config,
                        apply_to_domain, ConfigError)
    out = _cli("serve", "--device", "cpu", "--port", "0", "--status-port",
               "0", "--config", str(tmp_path / "bad.toml"))
    assert out.returncode != 0
    assert err in out.stderr
    assert "listening" not in out.stdout


def test_serve_without_a_gpu_exits_before_binding():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: serve would start on it")
    out = _cli("serve", "--port", "0", "--status-port", "0")
    assert out.returncode != 0
    assert "torch.cuda.is_available() is false" in out.stderr
    assert "listening" not in out.stdout


def test_serve_help_names_the_device_and_the_missing_workers():
    out = _cli("serve", "--help")
    assert out.returncode == 0
    text = " ".join(out.stdout.split())
    assert "--device" in text
    assert "background workers" in text and "not started" in text
