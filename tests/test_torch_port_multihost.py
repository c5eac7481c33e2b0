"""Multi-process start-up and DCN x ICI meshes: the port against JAX's
``parallel/multihost.py``.

One process: the port's meshes over ``["cpu"] * 8`` have JAX's axis names
and shapes over its 8 virtual devices, and its errors name the same
quantities ("process count", "devices"). Two processes: a gloo group on the
CPU, spawned as fresh interpreters on a free local port; each rank's
``initialize`` returns 2, a second call is a no-op, and both mesh functions
build over the two processes, laid out as JAX's hybrid mesh lays out
``tests/test_multihost.py``'s fake devices of two processes.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cadence_gemma_tpu.parallel import multihost as jmultihost
from tests import test_multihost as jmh_tests
from cadence_gemma_tpu_torch.parallel import multihost
from cadence_gemma_tpu_torch.parallel import sharding

REPO = pathlib.Path(__file__).resolve().parent.parent
CPUS = ["cpu"] * 8

MESHES = {
    "(2, 4) data x model": dict(ici_axis_shapes=(2, 4),
                                ici_axis_names=("data", "model")),
    "(8,) stage": dict(ici_axis_shapes=(8,), ici_axis_names=("stage",)),
    "(4, 2) stage x data": dict(ici_axis_shapes=(4, 2),
                                ici_axis_names=("stage", "data")),
    "two DCN axes": dict(ici_axis_shapes=(2, 4),
                         ici_axis_names=("data", "model"),
                         dcn_axis_shapes=(1, 1), dcn_axis_names=("a", "b")),
}


@pytest.mark.parametrize("case", list(MESHES))
def test_single_process_mesh_matches_jax(case):
  kwargs = MESHES[case]
  got = multihost.make_hybrid_mesh(**kwargs, devices=CPUS)
  want = jmultihost.make_hybrid_mesh(**kwargs, devices=jax.devices())
  assert got.axis_names == want.axis_names
  assert got.shape == dict(want.shape)
  assert list(got.devices.flat) == [torch.device("cpu")] * 8


@pytest.mark.parametrize("shape", [(2, 2, 2), (8, 1, 1), (1, 2, 4)])
def test_dp_preset_matches_jax(shape):
  data, sequence, model = shape
  got = multihost.dp_over_dcn_mesh(data, sequence, model, devices=CPUS)
  want = jmultihost.dp_over_dcn_mesh(data, sequence, model,
                                     devices=jax.devices())
  assert got.axis_names == want.axis_names == ("dcn", "data", "sequence",
                                               "model")
  assert got.shape == dict(want.shape)


ERRORS = {
    "process count": dict(ici_axis_shapes=(2, 4),
                          ici_axis_names=("data", "model"),
                          dcn_axis_shapes=(2,)),
    "devices": dict(ici_axis_shapes=(2, 2), ici_axis_names=("data", "model")),
    "mismatch": dict(ici_axis_shapes=(8,), ici_axis_names=("data",),
                     dcn_axis_shapes=(1, 1)),
}


@pytest.mark.parametrize("error", list(ERRORS))
def test_errors_match_jax(error):
  with pytest.raises(ValueError, match=error) as got:
    multihost.make_hybrid_mesh(**ERRORS[error], devices=CPUS)
  with pytest.raises(ValueError, match=error) as want:
    jmultihost.make_hybrid_mesh(**ERRORS[error], devices=jax.devices())
  assert str(got.value) == str(want.value)


def test_default_devices_are_the_cards(monkeypatch):
  """``devices=None`` means this process's cards, and raises without one,
  as ``sharding.make_mesh`` does: no fallback to the CPU."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="No CUDA device"):
    multihost.make_hybrid_mesh((1,), ("data",))
  with pytest.raises(RuntimeError, match="No CUDA device"):
    multihost.dp_over_dcn_mesh()
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
  mesh = multihost.make_hybrid_mesh((2,), ("stage",))
  assert list(mesh.devices.flat) == [torch.device("cuda", 0),
                                     torch.device("cuda", 1)]


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
  for name in ("WORLD_SIZE", "MASTER_ADDR", "JAX_COORDINATOR_ADDRESS",
               "COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES"):
    monkeypatch.delenv(name, raising=False)
  assert multihost.initialize() == jmultihost.initialize() == 1
  monkeypatch.setenv("WORLD_SIZE", "1")
  monkeypatch.setenv("MASTER_ADDR", "localhost")
  assert multihost.initialize() == 1
  assert not torch.distributed.is_initialized()
  assert multihost.process_count() == 1


def test_several_processes_refused_naming_the_item(monkeypatch):
  """Over 2 processes the mesh functions build (the gloo test below); a
  DCN shape that is not the process count raises JAX's error before any
  collective, and what still runs on one controller only names item 14h."""
  monkeypatch.setattr(multihost, "process_count", lambda: 2)
  fakes = jmh_tests.fake_topology(n_proc=2, per_proc=4)
  for kwargs in (dict(dcn_axis_shapes=(1,)), dict(dcn_axis_shapes=(4,))):
    with pytest.raises(ValueError) as got:
      multihost.make_hybrid_mesh((4,), ("data",), devices=CPUS[:4], **kwargs)
    with pytest.raises(ValueError) as want:
      jmultihost.make_hybrid_mesh((4,), ("data",), devices=fakes, **kwargs)
    assert str(got.value) == str(want.value)
  assert "item 14h" in sharding.PROCESS_PER_CARD_ITEM


_RANK = r"""
import json, sys
from cadence_gemma_tpu_torch.parallel import multihost
rank, port = int(sys.argv[1]), int(sys.argv[2])
out = {"first": multihost.initialize(f"localhost:{port}", 2, rank,
                                     backend="gloo")}
out["second"] = multihost.initialize(f"localhost:{port}", 2, rank,
                                     backend="gloo")
out["count"] = multihost.process_count()
for name, call in (("hybrid", lambda: multihost.make_hybrid_mesh(
                       (2,), ("data",), devices=["cpu"] * 2)),
                   ("preset", lambda: multihost.dp_over_dcn_mesh(
                       1, 2, devices=["cpu"] * 2))):
  mesh = call()
  out[name] = {"names": list(mesh.axis_names), "ranks": mesh.ranks.tolist(),
               "spans": mesh.spans_processes}
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
print(json.dumps(out))
"""


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def test_two_process_gloo_group():
  port = _free_port()
  env = dict(os.environ, PYTHONPATH=str(REPO))
  for name in ("WORLD_SIZE", "MASTER_ADDR", "RANK"):
    env.pop(name, None)
  procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(rank),
                             str(port)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
           for rank in range(2)]
  results = []
  try:
    for proc in procs:
      out, err = proc.communicate(timeout=120)
      assert proc.returncode == 0, err[-2000:]
      results.append(json.loads(out.strip().splitlines()[-1]))
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
  fakes = jmh_tests.fake_topology(n_proc=2, per_proc=2)
  want = {"hybrid": jmultihost.make_hybrid_mesh((2,), ("data",),
                                                devices=fakes),
          "preset": jmultihost.dp_over_dcn_mesh(1, 2, devices=fakes)}
  for out in results:
    assert out["first"] == out["second"] == out["count"] == 2
    for name, mesh in want.items():
      assert out[name]["spans"]
      assert tuple(out[name]["names"]) == mesh.axis_names
      assert out[name]["ranks"] == np.vectorize(
          lambda d: d.process_index)(np.asarray(mesh.devices)).tolist()
