"""One process a card: the port's ``torch.distributed`` regime against JAX.

Every multi-process case runs in one gloo group of 4 CPU ranks, spawned as
fresh interpreters that import torch and the port alone (the 2-rank cases
on sub-meshes of it: ranks 0-1 and 2-3 run two at once); the JAX
references and the single-process runs are computed here. The cases:

  * the four collectives in SPMD form over a domain of one position a
    process and of two, against the single-controller functions on the
    same values: ``all_gather``, ``all_gather_features`` and ``ppermute``
    bit for bit, ``psum`` within 1e-6; their autograd transposes against
    autograd of the single-controller functions;
  * ``make_hybrid_mesh`` / ``dp_over_dcn_mesh`` over 4 processes, laid out
    as JAX's ``create_hybrid_device_mesh(process_is_granule=True)`` lays
    out ``tests/test_multihost.py``'s fake devices, with JAX's errors;
  * JAX's pmap regime (a mesh-less spec, ``sharding.axis_env``): the
    native and kernel paths, real and complex, reverse, index groups, and
    gradients, against ``jax.pmap`` as ``tests/test_scan.py:166-190`` runs
    it and ``jax.grad`` of JAX's scan (atol 1e-5);
  * the channel-sharded scan (``activations_axis_name``) against JAX's
    ``shard_map`` with ``P(None, "seq", "model")`` on the 8 virtual CPU
    devices, in one process and across 4 (a ``(seq 4, model 2)`` mesh, two
    positions a process), forward and gradients;
  * ``train_loop(mesh=)`` over a ``data`` axis of 2 processes, 3 steps on
    rows of unequal target counts: JAX's ``train_loop(mesh=)`` on a (2, 1)
    mesh (losses within 1e-4, weights within 1e-5 as
    ``test_torch_port_tp_training.py`` holds them), the port's
    single-process run (bit for bit) and replicas bit for bit equal after
    every step; a LoRA run and gradient accumulation with validation,
    each against JAX and the one-process run; a checkpoint written by
    process 0 (async) and resumed on both; checkpoints saved within an
    accumulation window and resumed; a preemption seen by one process;
  * the item-14h refusals.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_gemma_tpu import common as jcommon
from cadence_gemma_tpu import complex_lib as jcomplex
from cadence_gemma_tpu.ops import scan as jscan
from cadence_gemma_tpu.parallel import multihost as jmultihost
from cadence_gemma_tpu.parallel import sharding as jsharding
from cadence_gemma_tpu.training import data as jdata
from cadence_gemma_tpu.training import train_loop as jtl
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.ops import scan
from cadence_gemma_tpu_torch.parallel import pipeline
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import tensor_parallel
from cadence_gemma_tpu_torch.training import data
from cadence_gemma_tpu_torch.training import train_loop as tl
from tests import test_multihost as jmh_tests
from tests import test_torch_port_tp_training as tpt

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
B, T, D = 2, 64, 8
ATOL = 1e-5
# The accumulation runs' microbatches, by index (as the workers take them).
WINDOWS = (0, 1, 2, 0)

# Spawned once, as rank ``argv[1]`` of ``WORLD``: reads ``inputs.pt`` and
# writes ``rank{r}.pt`` under ``argv[3]``.
_WORKER = r'''
import json, os, sys
import numpy as np
import torch
from torch import distributed as dist
from cadence_gemma_tpu_torch import common, complex_lib
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.ops import scan
from cadence_gemma_tpu_torch.parallel import multihost, sharding
from cadence_gemma_tpu_torch.training import data, train_loop as tl
from cadence_gemma_tpu_torch.utils import resilience

rank, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
world = multihost.initialize(f"localhost:{port}", 4, rank, backend="gloo")
inp = torch.load(os.path.join(root, "inputs.pt"))
cfg = json.loads(inp["config"])
out = {"world": world}
cpu = torch.device("cpu")


def domain(per):
  return sharding.Domain(tuple(r for r in range(4) for _ in range(per)),
                         (cpu,) * (4 * per), dist.group.WORLD)


# -- the collectives ----------------------------------------------------
for per in (1, 2):
  dom = domain(per)
  n = 4 * per
  mine = dom.local
  vals = [inp["coll"][p].clone().requires_grad_() for p in mine]
  # One backward a collective: the processes run their transposes in step.
  gathered = sharding.all_gather(vals, dom)
  sum((inp["w"][q, p] * gathered[k][p]).sum()
      for k, q in enumerate(mine) for p in range(n)).backward()
  feats = sharding.all_gather_features(vals, dom)
  sum((inp["wf"][q, :, :4 * n] * feats[k]).sum()
      for k, q in enumerate(mine)).backward()
  sums = sharding.psum(vals, dom)
  sum((inp["ws"][q] * sums[k]).sum() for k, q in enumerate(mine)).backward()
  perm = [(p, (p + 1) % n) for p in range(n)] if per == 1 else [
      (0, 3), (3, 0), (5, 1), (6, 6), (2, 7), (7, 2), (4, 5)]
  moved = sharding.ppermute(vals, dom, perm)
  sum((inp["ws"][q] * moved[k]).sum() for k, q in enumerate(mine)).backward()
  out[f"coll{per}"] = {
      "gather": [[t.detach() for t in g] for g in gathered],
      "features": [t.detach() for t in feats],
      "psum": [t.detach() for t in sums],
      "ppermute": [t.detach() for t in moved],
      "grads": [v.grad for v in vals], "mine": mine}

# -- the meshes ----------------------------------------------------------
meshes = {}
for name, kw in json.loads(inp["meshes"]).items():
  fn = (multihost.dp_over_dcn_mesh if kw.pop("preset", False)
        else multihost.make_hybrid_mesh)
  try:
    m = fn(**kw)
    meshes[name] = {"names": list(m.axis_names),
                    "shape": list(m.devices.shape),
                    "ranks": m.ranks.tolist(),
                    "devices": [str(d) for d in m.devices.flat]}
  except ValueError as e:
    meshes[name] = {"error": str(e)}
out["meshes"] = meshes

# -- the pmap regime -----------------------------------------------------
x_all, a_all, h0 = inp["x"], inp["a"], inp["h0"]
t = x_all.shape[1] // 4
sl = slice(rank * t, (rank + 1) * t)
pm = {}
for kind, groups in (("plain", None), ("groups", [[0, 1], [2, 3]])):
  for scan_name in ("LINEAR_NATIVE", "LINEAR_PALLAS", "ASSOCIATIVE_NATIVE"):
    for reverse in (False, True):
      for cplx in (False, True):
        if cplx and scan_name == "ASSOCIATIVE_NATIVE":
          continue
        if cplx:
          x = complex_lib.Complex(x_all[:, sl].clone(), inp["xi"][:, sl].clone())
          a = complex_lib.Complex(a_all[:, sl].clone(), inp["ai"][:, sl].clone())
          h = complex_lib.Complex(h0.clone(), inp["h0i"].clone())
          leaves = [x.real, x.imag, a.real, a.imag, h.real, h.imag]
        else:
          x, a, h = x_all[:, sl].clone(), a_all[:, sl].clone(), h0.clone()
          leaves = [x, a, h]
        for v in leaves:
          v.requires_grad_()
        spec = sharding.ShardingSpec(mesh=None, sequence_axis_name="seq",
                                     sequence_axis_index_groups=groups)
        with sharding.axis_env(seq=None):
          y, hl = scan.linear_scan(x, a, h, reverse=reverse,
                                   scan_type=common.ScanType[scan_name],
                                   sharding_spec=spec)
          domain_ranks = [0, 1, 2, 3] if groups is None else (
              [0, 1] if rank < 2 else [2, 3])
          last = domain_ranks[0] if reverse else domain_ranks[-1]
          gy = inp["gy"][:, sl]
          gh = inp["gh"][0 if rank < 2 or groups is None else 1]
          if cplx:
            loss = (y.real * gy).sum() + (y.imag * gy).sum()
            if rank == last:
              loss = loss + (hl.real * gh).sum() - (hl.imag * gh).sum()
          else:
            loss = (y * gy).sum() + ((hl * gh).sum() if rank == last else 0)
          loss.backward()
        key = f"{kind} {scan_name} rev={reverse} complex={cplx}"
        parts = [y.real, y.imag, hl.real, hl.imag] if cplx else [y, hl]
        pm[key] = {"out": [p.detach() for p in parts],
                   "grads": [v.grad for v in leaves]}
out["pmap"] = pm

# -- the channel-sharded scan across processes ---------------------------
mesh = multihost.make_hybrid_mesh((2,), ("model",), dcn_axis_shapes=(4,),
                                  dcn_axis_names=("seq",),
                                  devices=["cpu"] * 2)
spec = sharding.ShardingSpec(mesh=mesh, sequence_axis_name="seq",
                             activations_axis_name="model")
ch = {}
for scan_name in ("LINEAR_NATIVE", "LINEAR_PALLAS"):
  for reverse in (False, True):
    x, a, h = (v.clone().requires_grad_() for v in (x_all, a_all, h0))
    y, hl = scan.linear_scan(x, a, h, reverse=reverse,
                             scan_type=common.ScanType[scan_name],
                             sharding_spec=spec)
    ((y * inp["gy"]).sum() + (hl * inp["gh"][0]).sum()).backward()
    ch[f"{scan_name} rev={reverse}"] = [y.detach(), hl.detach(), x.grad,
                                        a.grad, h.grad]
out["channels"] = ch

# -- data-parallel training over 2-process sub-meshes --------------------
config = common.GriffinConfig(**{
    **cfg, "block_types": tuple(common.TemporalBlockType[b]
                                for b in cfg["block_types"]),
    "scan_type": common.ScanType[cfg["scan_type"]]})


def dp_mesh(ranks):
  flat = np.empty(2, dtype=object)
  flat[:] = [cpu, cpu]
  return sharding.Mesh(flat.reshape(2, 1), ("data", "model"),
                       np.array(ranks).reshape(2, 1)).build_groups()


meshes = {"A": dp_mesh([0, 1]), "B": dp_mesh([2, 3])}


def model_from(state, lora_rank=0):
  m = griffin.Griffin(config, device="meta", dtype=torch.float32,
                      lora_rank=lora_rank)
  m.to_empty(device="cpu")
  m.load_state_dict(state)
  return m


def run(model, batches, mesh, val=None, **kw):
  losses, states = [], []

  def log(metrics, step):
    losses.append(metrics["train_loss"])
    states.append({k: v.detach().clone() for k, v in model.state_dict().items()})
    if "val_loss" in metrics:
      losses.append(metrics["val_loss"])

  kw = {"learning_rate": 1e-3, "eval_every_n": 1,
        "checkpoint_every_n": None, **kw}
  tl.train_loop(model, [data.TrainingInput(tk, mk) for tk, mk in batches],
                tl.TrainingConfig(**kw), validation_data=val, log_metrics=log,
                pad_id=0, device="cpu", mesh=mesh)
  return losses, states


batches = [tuple(b) for b in inp["batches"]]
# Two windows of two different microbatches (a window of one batch twice
# would hide a wrong scale: the clip normalizes it away).
windows = [batches[i] for i in inp["windows"]]
dp = {}
if rank < 2:
  mesh = meshes["A"]
  dp["full"] = run(model_from(inp["params"]), batches, mesh, max_steps=3)
  ckpt = os.path.join(root, "ckpt")
  run(model_from(inp["params"]), batches, mesh, max_steps=2,
      checkpoint_every_n=2, checkpoint_dir=ckpt, async_checkpoints=True)
  dp["files"] = sorted(os.listdir(ckpt))
  dp["resumed"] = run(model_from(inp["params"]), batches, mesh, max_steps=3,
                      resume_from=os.path.join(ckpt, "step_2"))
  # Windows of 2: saved within a window (steps 1 and 3) and resumed.
  accum = dict(max_steps=4, gradient_accumulation_steps=2)
  dp["accum_full"] = run(model_from(inp["params"]), windows, mesh, **accum)
  mid = os.path.join(root, "mid")
  run(model_from(inp["params"]), windows, mesh, max_steps=3,
      gradient_accumulation_steps=2, checkpoint_every_n=1, checkpoint_dir=mid)
  dp["mid_files"] = sorted(os.listdir(mid))
  dp["mid_resumed"] = run(model_from(inp["params"]), windows, mesh,
                          resume_from=os.path.join(mid, "step_3"), **accum)
  # A preemption that fires on process 1 alone, after step 2.
  handler = resilience.PreemptionHandler()
  logged = []

  def log_preempted(metrics, step):
    logged.append([step, sorted(metrics)])
    if rank == 1 and step == 2:
      handler.trigger()

  pre = os.path.join(root, "preempt")
  tl.train_loop(model_from(inp["params"]),
                [data.TrainingInput(tk, mk) for tk, mk in windows],
                tl.TrainingConfig(learning_rate=1e-3, eval_every_n=1,
                                  checkpoint_every_n=None, checkpoint_dir=pre,
                                  **accum),
                log_metrics=log_preempted, pad_id=0, device="cpu", mesh=mesh,
                preemption=handler)
  dp["preempted"] = {"logged": logged, "files": sorted(os.listdir(pre))}
  dp["preempt_resumed"] = run(
      model_from(inp["params"]), windows, mesh,
      resume_from=os.path.join(pre, "preempted_step_3"), **accum)
else:
  mesh = meshes["B"]
  dp["lora"] = run(model_from(inp["lora_params"], lora_rank=2), batches[:2],
                   mesh, max_steps=2, lora=True)
  val = [data.TrainingInput(*batches[0])]
  dp["accum"] = run(model_from(inp["params"]), windows, mesh, val=val,
                    max_steps=4, gradient_accumulation_steps=2)
out["dp"] = dp
torch.save(out, os.path.join(root, f"rank{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
print("done", rank)
'''


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


# The meshes every rank builds, in order (each a dict of keyword arguments;
# ``preset`` selects dp_over_dcn_mesh).
MESHES = {
    "(2,) model, dcn 4": dict(ici_axis_shapes=(2,), ici_axis_names=("model",),
                              devices=["cpu"] * 2),
    "(2, 1) data x model, dcn (2, 2)": dict(
        ici_axis_shapes=(2, 1), ici_axis_names=("data", "model"),
        dcn_axis_shapes=(2, 2), dcn_axis_names=("a", "b"),
        devices=["cpu"] * 2),
    "preset (1, 2, 1)": dict(preset=True, data=1, sequence=2, model=1,
                             devices=["cpu"] * 2),
    "process count": dict(ici_axis_shapes=(2,), ici_axis_names=("model",),
                          dcn_axis_shapes=(3,), devices=["cpu"] * 2),
    "devices": dict(ici_axis_shapes=(2,), ici_axis_names=("model",),
                    devices=["cpu"] * 3),
}


def _scan_inputs():
  rng = np.random.default_rng(7)
  f = lambda *s: rng.standard_normal(s).astype(np.float32)  # pylint: disable=unnecessary-lambda-assignment
  x, xi = f(B, T, D), f(B, T, D)
  a = rng.uniform(0.5, 0.99, (B, T, D)).astype(np.float32)
  ai = (0.1 * f(B, T, D)).astype(np.float32)
  h0, h0i = f(B, D), f(B, D)
  gy, gh = f(B, T, D), f(2, B, D)
  return dict(x=x, xi=xi, a=a, ai=ai, h0=h0, h0i=h0i, gy=gy, gh=gh)


def _config_json() -> str:
  fields = tpt._port_config(tpt._jax_config())._asdict()  # pylint: disable=protected-access
  fields["block_types"] = [b.name for b in fields["block_types"]]
  fields["scan_type"] = fields["scan_type"].name
  return json.dumps(fields)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  """Runs the 4 ranks once; returns ``(results by rank, inputs)``."""
  root = tmp_path_factory.mktemp("process_per_card")
  rng = np.random.default_rng(3)
  params = tpt._seeded_params(tpt._jax_model(), 11)  # pylint: disable=protected-access
  lora_params = tpt._seeded_params(tpt._jax_model(lora_rank=2), 12)  # pylint: disable=protected-access
  scan_in = _scan_inputs()
  inputs = {k: torch.tensor(v) for k, v in scan_in.items()}
  inputs.update(
      coll=torch.tensor(rng.standard_normal((8, 3, 4)), dtype=torch.float32),
      w=torch.tensor(rng.standard_normal((8, 8, 3, 4)), dtype=torch.float32),
      wf=torch.tensor(rng.standard_normal((8, 3, 32)), dtype=torch.float32),
      ws=torch.tensor(rng.standard_normal((8, 3, 4)), dtype=torch.float32),
      config=_config_json(), meshes=json.dumps(MESHES), windows=WINDOWS,
      params=tpt._port_model(params).state_dict(),  # pylint: disable=protected-access
      lora_params=tpt._port_model(lora_params, lora_rank=2).state_dict(),  # pylint: disable=protected-access
      batches=[[torch.tensor(t), torch.tensor(m)]
               for t, m in tpt._loader_batches(3)])  # pylint: disable=protected-access
  torch.save(inputs, root / "inputs.pt")
  env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
  for name in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK"):
    env.pop(name, None)
  port = _free_port()
  procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port),
                             str(root)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
           for r in range(WORLD)]
  try:
    for proc in procs:
      _, err = proc.communicate(timeout=240)
      assert proc.returncode == 0, err[-3000:]
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
  results = [torch.load(root / f"rank{r}.pt") for r in range(WORLD)]
  return results, dict(inputs, params_jax=params, lora_jax=lora_params,
                       scan=scan_in)


# -- the collectives ------------------------------------------------------------


@pytest.mark.parametrize("per", [1, 2])
def test_collectives_match_the_single_controller(world, per):
  results, inp = world
  n = 4 * per
  vals = [inp["coll"][p].clone().requires_grad_() for p in range(n)]
  devices = [torch.device("cpu")] * n
  gathered = sharding.all_gather(vals, devices)
  feats = sharding.all_gather_features(vals, devices)
  sums = sharding.psum(vals, devices)
  perm = [(p, (p + 1) % n) for p in range(n)] if per == 1 else [
      (0, 3), (3, 0), (5, 1), (6, 6), (2, 7), (7, 2), (4, 5)]
  moved = sharding.ppermute(vals, devices, perm)
  loss = sum((inp["w"][q, p] * gathered[q][p]).sum()
             for q in range(n) for p in range(n))
  loss = loss + sum((inp["wf"][q, :, :4 * n] * feats[q]).sum()
                    for q in range(n))
  loss = loss + sum((inp["ws"][q] * sums[q]).sum() for q in range(n))
  loss = loss + sum((inp["ws"][q] * moved[q]).sum() for q in range(n))
  loss.backward()
  seen = set()
  for r in range(WORLD):
    got = results[r][f"coll{per}"]
    assert got["mine"] == [r * per + j for j in range(per)]
    for k, q in enumerate(got["mine"]):
      seen.add(q)
      for p in range(n):
        assert torch.equal(got["gather"][k][p], gathered[q][p].detach())
      assert torch.equal(got["features"][k], feats[q].detach())
      assert torch.equal(got["ppermute"][k], moved[q].detach())
      torch.testing.assert_close(got["psum"][k], sums[q].detach(), rtol=1e-6,
                                 atol=1e-6)
      torch.testing.assert_close(got["grads"][k], vals[q].grad, rtol=1e-6,
                                 atol=1e-5)
  assert seen == set(range(n))


# -- the meshes -----------------------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
def test_process_meshes_match_jax_layout(world, name):
  results, _ = world
  kwargs = dict(MESHES[name])
  per = len(kwargs.pop("devices"))
  fakes = jmh_tests.fake_topology(n_proc=WORLD, per_proc=per)
  jfn = (jmultihost.dp_over_dcn_mesh if kwargs.pop("preset", False)
         else jmultihost.make_hybrid_mesh)
  got = [r["meshes"][name] for r in results]
  if "error" in got[0]:
    with pytest.raises(ValueError) as want:
      jfn(**kwargs, devices=fakes)
    assert all(g["error"] == str(want.value) for g in got)
    return
  want = jfn(**kwargs, devices=fakes)
  arr = np.asarray(want.devices)
  for g in got:
    assert tuple(g["names"]) == want.axis_names
    assert tuple(g["shape"]) == arr.shape
    assert g["ranks"] == np.vectorize(lambda d: d.process_index)(arr).tolist()
  # Within a process, the port keeps its devices' order as JAX keeps ids.
  local = np.vectorize(lambda d: d.id % per)(arr)
  assert (np.asarray(got[0]["ranks"]) * per + local).tolist() == (
      np.vectorize(lambda d: d.id)(arr).tolist())


# -- the pmap regime ------------------------------------------------------------


def _jax_global(sc, reverse, groups, cplx):
  """JAX's scan of each domain (the whole sequence, or each half under the
  index groups) from h0, and ``jax.grad`` of the workers' loss."""
  def complexify(re, im):
    return jcomplex.Complex(re, im) if cplx else re

  def fn(x, xi, a, ai, h0, h0i):
    x, a, h0 = complexify(x, xi), complexify(a, ai), complexify(h0, h0i)
    halves = [(0, T)] if groups is None else [(0, T // 2), (T // 2, T)]
    ys, loss = [], 0.0
    for d, (s0, s1) in enumerate(halves):
      y, h = jscan.lru_linear_scan(x[:, s0:s1], a[:, s0:s1], h0,
                                   reverse=reverse)
      gh = sc["gh"][d]
      if cplx:
        loss += (h.real * gh).sum() - (h.imag * gh).sum()
      else:
        loss += (h * gh).sum()
      ys.append(y)
    y = jcomplex.concatenate(ys, axis=1) if cplx else jnp.concatenate(ys, 1)
    if cplx:
      loss += (y.real * sc["gy"]).sum() + (y.imag * sc["gy"]).sum()
    else:
      loss += (y * sc["gy"]).sum()
    return loss

  args = [jnp.asarray(sc[k]) for k in ("x", "xi", "a", "ai", "h0", "h0i")]
  return jax.grad(fn, argnums=tuple(range(6)))(*args)


PMAP_CASES = [f"{kind} {s} rev={rev} complex={c}"
              for kind in ("plain", "groups")
              for s in ("LINEAR_NATIVE", "LINEAR_PALLAS", "ASSOCIATIVE_NATIVE")
              for rev in (False, True) for c in (False, True)
              if not (c and s == "ASSOCIATIVE_NATIVE")]


@pytest.mark.parametrize("case", PMAP_CASES)
def test_pmap_regime_matches_jax(world, case):
  results, inp = world
  sc = inp["scan"]
  groups = None if case.startswith("plain") else [[0, 1], [2, 3]]
  reverse, cplx = "rev=True" in case, "complex=True" in case
  # Forward: jax.pmap of the mesh-less spec, as test_scan.py runs it.
  jspec = jsharding.ShardingSpec(mesh=None, sequence_axis_name="seq")

  def shard_fn(x, xi, a, ai, h0, h0i):
    if cplx:
      x, a, h0 = (jcomplex.Complex(x, xi), jcomplex.Complex(a, ai),
                  jcomplex.Complex(h0, h0i))
    return jscan.linear_scan(x, a, h0, reverse=reverse,
                             scan_type=jcommon.ScanType.LINEAR_NATIVE,
                             sharding_spec=jspec)

  def split(v):
    return jnp.stack(jnp.split(jnp.asarray(v), WORLD, axis=1))

  if groups is None:
    args = [split(sc[k]) for k in ("x", "xi", "a", "ai")]
    args = args + [jnp.broadcast_to(jnp.asarray(sc[k]), (WORLD, B, D))
                   for k in ("h0", "h0i")]
    y_sh, h_sh = jax.pmap(shard_fn, axis_name="seq")(*args)
  t = T // WORLD
  for r in range(WORLD):
    got = results[r]["pmap"][case]["out"]
    if groups is None:
      want = ([y_sh.real[r], y_sh.imag[r], h_sh.real[r], h_sh.imag[r]]
              if cplx else [y_sh[r], h_sh[r]])
    else:
      half = slice(0, T // 2) if r < 2 else slice(T // 2, T)
      x, a, h0 = (jnp.asarray(sc[k]) for k in ("x", "a", "h0"))
      if cplx:
        x = jcomplex.Complex(x, jnp.asarray(sc["xi"]))
        a = jcomplex.Complex(a, jnp.asarray(sc["ai"]))
        h0 = jcomplex.Complex(h0, jnp.asarray(sc["h0i"]))
      y, h = jscan.lru_linear_scan(x[:, half], a[:, half], h0,
                                   reverse=reverse)
      local = slice((r % 2) * t, (r % 2 + 1) * t)
      want = ([y.real[:, local], y.imag[:, local], h.real, h.imag] if cplx
              else [y[:, local], h])
    for g, w in zip(got, want):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
  # Gradients: each rank's shard of jax.grad of JAX's scan; dh0 summed.
  jgrads = _jax_global(sc, reverse, groups, cplx)
  order = [0, 1, 2, 3, 4, 5] if cplx else [0, 2, 4]
  for r in range(WORLD):
    grads = results[r]["pmap"][case]["grads"]
    for g, k in zip(grads[:-2 if cplx else -1], order):
      np.testing.assert_allclose(g.numpy(), np.asarray(
          jgrads[k][:, r * t:(r + 1) * t]), atol=ATOL, err_msg=str(k))
  for j, k in enumerate(order[-2:] if cplx else order[-1:]):
    total = sum(res["pmap"][case]["grads"][-(2 if cplx else 1) + j]
                for res in results)
    np.testing.assert_allclose(total.numpy(), np.asarray(jgrads[k]),
                               atol=ATOL)


# -- the channel-sharded scan ---------------------------------------------------


def _jax_channel_scan(sc, scan_type, reverse):
  jmesh = jsharding.make_mesh((4, 2), ("seq", "model"), jax.devices()[:8])
  jspec = jsharding.ShardingSpec(mesh=jmesh, sequence_axis_name="seq",
                                 activations_axis_name="model")

  def fn(x, a, h0):
    y, h = jscan.linear_scan(x, a, h0, reverse=reverse, scan_type=scan_type,
                             sharding_spec=jspec)
    return (y * sc["gy"]).sum() + (h * sc["gh"][0]).sum(), (y, h)

  args = [jnp.asarray(sc[k]) for k in ("x", "a", "h0")]
  grads, (y, h) = jax.jit(jax.grad(fn, argnums=(0, 1, 2), has_aux=True))(
      *args)
  return [y, h, *grads]


CHANNEL_CASES = [f"{s} rev={rev}" for s in ("LINEAR_NATIVE", "LINEAR_PALLAS")
                 for rev in (False, True)]


@pytest.mark.parametrize("case", CHANNEL_CASES)
def test_channel_sharded_scan_matches_shard_map(world, case):
  """One process (``["cpu"] * 8``) and 4 processes against JAX's
  ``shard_map`` with ``P(None, "seq", "model")``; every process holds the
  whole result and gradient."""
  results, inp = world
  sc = inp["scan"]
  reverse = "rev=True" in case
  want = _jax_channel_scan(sc, jcommon.ScanType.LINEAR_NATIVE, reverse)
  mesh = sharding.make_mesh((4, 2), ("seq", "model"), ["cpu"] * 8)
  spec = sharding.ShardingSpec(mesh=mesh, sequence_axis_name="seq",
                               activations_axis_name="model")
  x, a, h0 = (torch.tensor(sc[k]).requires_grad_() for k in ("x", "a", "h0"))
  y, h = scan.linear_scan(x, a, h0, reverse=reverse,
                          scan_type=common.ScanType[case.split()[0]],
                          sharding_spec=spec)
  ((y * inp["gy"]).sum() + (h * inp["gh"][0]).sum()).backward()
  one = [y.detach(), h.detach(), x.grad, a.grad, h0.grad]
  for g, w in zip(one, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
  for r in range(WORLD):
    for g, mine in zip(results[r]["channels"][case], one):
      torch.testing.assert_close(g, mine, atol=ATOL, rtol=0)


# -- data-parallel training -----------------------------------------------------


def _single_process_run(state, batches, **kw):
  """The port's one-process ``train_loop(mesh=)`` on a (2, 1) mesh."""
  model = griffin.Griffin(
      tpt._port_config(tpt._jax_config()), device="meta",  # pylint: disable=protected-access
      dtype=torch.float32, lora_rank=kw.pop("lora_rank", 0))
  model.to_empty(device="cpu")
  model.load_state_dict(state)
  mesh = sharding.make_mesh((2, 1), ("data", "model"), ["cpu"] * 2)
  losses = []

  def log(metrics, step):
    del step
    losses.append(metrics["train_loss"])
    if "val_loss" in metrics:
      losses.append(metrics["val_loss"])

  val = kw.pop("val", None)
  tl.train_loop(model, [data.TrainingInput(t, m) for t, m in batches],
                tl.TrainingConfig(learning_rate=1e-3, eval_every_n=1,
                                  checkpoint_every_n=None, **kw),
                validation_data=val, log_metrics=log, pad_id=0, device="cpu",
                mesh=mesh)
  return losses, model.state_dict()


def _assert_replicas(results, key, ranks):
  (l0, s0), (l1, s1) = (results[r]["dp"][key] for r in ranks)
  assert l0 == l1
  assert len(s0) == len(s1)
  for a, b in zip(s0, s1):
    for name in a:
      assert torch.equal(a[name], b[name]), (key, name)
  return l0, s0


def test_dp_train_loop_matches_jax_and_one_process(world):
  """3 steps on a data axis of 2 processes: JAX's train_loop(mesh=) on
  (2, 1) (losses within 1e-4, weights within 1e-5), the port's one-process
  run bit for bit, replicas bit for bit after every step; the rows' target
  counts differ (10, 6, 8, 4 real tokens)."""
  results, inp = world
  losses, states = _assert_replicas(results, "full", (0, 1))
  batches = [(t.numpy(), m.numpy()) for t, m in inp["batches"]]
  jmesh = jsharding.make_mesh((2, 1), ("data", "model"), jax.devices()[:2])
  want, want_losses = tpt._jax_loop(  # pylint: disable=protected-access
      tpt._jax_model(), inp["params_jax"], batches,  # pylint: disable=protected-access
      jtl.TrainingConfig(learning_rate=1e-3, max_steps=3, eval_every_n=1,
                         checkpoint_every_n=None), jmesh)
  np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
  tpt._assert_state_close(states[-1], want, 1e-5)  # pylint: disable=protected-access
  one_losses, one_state = _single_process_run(
      inp["params"], [(t, m) for t, m in inp["batches"]], max_steps=3)
  assert losses == one_losses
  for name, value in one_state.items():
    assert torch.equal(states[-1][name], value), name


def test_checkpoint_from_process_zero_resumes_on_both(world):
  """Process 0 wrote ``step_2`` (async), and both processes resumed from it
  to step 3: the uninterrupted run's weights (within 1e-6)."""
  results, _ = world
  assert results[0]["dp"]["files"] == results[1]["dp"]["files"] == ["step_2"]
  _, full = _assert_replicas(results, "full", (0, 1))
  losses, resumed = _assert_replicas(results, "resumed", (0, 1))
  assert len(losses) == 1
  np.testing.assert_allclose(losses[0], results[0]["dp"]["full"][0][2],
                             rtol=1e-6)
  for name, value in full[-1].items():
    torch.testing.assert_close(resumed[-1][name], value, atol=1e-6, rtol=0,
                               msg=name)


def _jax_run(params, batches, val=None, lora_rank=0, **kw):
  """JAX's ``train_loop(mesh=)`` on a (2, 1) data mesh; returns the final
  tree and the logged losses (train, then validation, at every step)."""
  logged = []

  def log(metrics, step):
    del step
    logged.append(metrics["train_loss"])
    if "val_loss" in metrics:
      logged.append(metrics["val_loss"])

  jmesh = jsharding.make_mesh((2, 1), ("data", "model"), jax.devices()[:2])
  out = jtl.train_loop(
      tpt._jax_model(lora_rank=lora_rank),  # pylint: disable=protected-access
      jax.tree_util.tree_map(jnp.asarray, params),
      [jdata.TrainingInput(t, m) for t, m in batches],
      jtl.TrainingConfig(learning_rate=1e-3, eval_every_n=1,
                         checkpoint_every_n=None, **kw),
      validation_data=val, log_metrics=log, pad_id=0, mesh=jmesh)
  return jax.tree_util.tree_map(np.asarray, out), logged


def test_dp_lora_and_accumulation_match_one_process(world):
  """On processes 2-3: 2 LoRA steps, and 4 microbatches in windows of 2
  with validation, each against JAX's train_loop(mesh=) on (2, 1) (losses
  within 1e-4, weights and adapters within 1e-5) and the port's
  one-process run (bit for bit)."""
  results, inp = world
  batches = [(t, m) for t, m in inp["batches"]]
  np_batches = [(t.numpy(), m.numpy()) for t, m in batches]
  for key, params, jparams, kw in (
      ("lora", "lora_params", "lora_jax",
       dict(max_steps=2, lora=True, lora_rank=2)),
      ("accum", "params", "params_jax",
       dict(max_steps=4, gradient_accumulation_steps=2))):
    runs = np_batches[:2] if key == "lora" else [np_batches[i]
                                                 for i in WINDOWS]
    losses, states = _assert_replicas(results, key, (2, 3))
    jval = val = None
    if key == "accum":
      jval = [jdata.TrainingInput(*np_batches[0])]
      val = [data.TrainingInput(*batches[0])]
    want, want_losses = _jax_run(inp[jparams], runs, val=jval, **kw)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4, err_msg=key)
    tpt._assert_state_close(states[-1], want, 1e-5)  # pylint: disable=protected-access
    one_losses, one_state = _single_process_run(
        inp[params], [(torch.tensor(t), torch.tensor(m)) for t, m in runs],
        val=val, **kw)
    assert losses == one_losses, key
    for name, value in one_state.items():
      assert torch.equal(states[-1][name], value), (key, name)


def test_mid_window_checkpoint_resumes_on_both(world):
  """Windows of 2 on processes 0-1, saved by process 0 after every step
  (steps 1 and 3 within a window, the saved window the sum over the
  processes) and resumed on both from step 3: the uninterrupted run's
  step-4 loss and weights (within 1e-6; the resumed window sums its terms
  in another order)."""
  results, _ = world
  for r in (0, 1):
    assert results[r]["dp"]["mid_files"] == ["step_1", "step_2", "step_3"]
  full_losses, full = _assert_replicas(results, "accum_full", (0, 1))
  losses, resumed = _assert_replicas(results, "mid_resumed", (0, 1))
  assert len(full_losses) == 4 and len(losses) == 1
  np.testing.assert_allclose(losses[0], full_losses[3], rtol=1e-6)
  for name, value in full[-1].items():
    torch.testing.assert_close(resumed[-1][name], value, atol=1e-6, rtol=0,
                               msg=name)


def test_preemption_on_one_process_stops_both(world):
  """A preemption that fires on process 1 alone after step 2 stops both
  processes at step 3, within a window; process 0 saves
  ``preempted_step_3`` once, and resuming it on both gives the
  uninterrupted run."""
  results, _ = world
  want = [[1, ["steps_per_sec", "train_loss"]],
          [2, ["steps_per_sec", "train_loss"]], [3, ["preempted_at"]]]
  for r in (0, 1):
    assert results[r]["dp"]["preempted"] == {
        "logged": want, "files": ["preempted_step_3"]}
  full_losses, full = _assert_replicas(results, "accum_full", (0, 1))
  losses, resumed = _assert_replicas(results, "preempt_resumed", (0, 1))
  np.testing.assert_allclose(losses, full_losses[3:], rtol=1e-6)
  for name, value in full[-1].items():
    torch.testing.assert_close(resumed[-1][name], value, atol=1e-6, rtol=0,
                               msg=name)


# -- refusals -------------------------------------------------------------------


def _fake_process_mesh(shape, names):
  """A mesh whose positions belong to processes 0 and 1 (no group: the
  refusals come before any collective)."""
  n = int(np.prod(shape))
  flat = np.empty(n, dtype=object)
  flat[:] = [torch.device("cpu")] * n
  ranks = np.arange(n) * 2 // n
  return sharding.Mesh(flat.reshape(shape), names, ranks.reshape(shape))


def _tiny():
  return tpt._port_model(tpt._seeded_params(tpt._jax_model(), 1))  # pylint: disable=protected-access


REFUSALS = {
    "SP across processes": lambda: griffin.Griffin(
        _tiny().config, device="cpu", scan_sharding_spec=sharding.ShardingSpec(
            mesh=_fake_process_mesh((2,), ("sequence",)),
            sequence_axis_name="sequence")),
    "SP under the pmap regime in the model": lambda: griffin.Griffin(
        _tiny().config, device="cpu", scan_sharding_spec=sharding.ShardingSpec(
            mesh=None, sequence_axis_name="sequence")),
    "TP across processes": lambda: tensor_parallel.tensor_parallel(
        _tiny(), _fake_process_mesh((1, 2), ("data", "model"))),
    "TP training across processes": lambda: tl.train_loop(
        _tiny(), [], tl.TrainingConfig(), device="cpu",
        mesh=_fake_process_mesh((1, 2), ("data", "model"))),
    "PP hops across processes": lambda: pipeline.GriffinPipeline(
        _tiny(), _fake_process_mesh((2,), ("stage",)), num_microbatches=2),
    "a leaf over two mesh axes": lambda: sharding.place(
        torch.zeros(2, 2), sharding.NamedSharding(
            sharding.make_mesh((1, 2), ("data", "model"), ["cpu"] * 2),
            sharding.PartitionSpec("data", "model"))),
}


@pytest.mark.parametrize("feature", list(REFUSALS))
def test_item_14h_refusals(feature):
  with pytest.raises(NotImplementedError, match="item 14h"):
    REFUSALS[feature]()


def test_pmap_regime_needs_a_bound_axis():
  """An unbound axis name raises as JAX's does."""
  x, a = torch.ones(1, 4, 2), torch.full((1, 4, 2), 0.5)
  spec = sharding.ShardingSpec(mesh=None, sequence_axis_name="seq")
  with pytest.raises(NameError, match="unbound axis name: seq"):
    scan.linear_scan(x, a, sharding_spec=spec)
