"""The port's walker sharding (``isokann_tpu_torch.parallel``) on the CPU.

Two gloo ranks, spawned once for the module (``ranks``), run every
rank-side case of ``RANK_CODE`` through a ``file://`` rendezvous under the
module's temporary directory (so that test workers never share a port),
each with a timeout on the rendezvous and on the processes.  The rank
processes import only the port; this process compares their results with
the JAX package (on its 8-device virtual mesh) and with the same cases at
world size 1 (no process group), run here from the same code.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu_torch as itt
from isokann_tpu.models import smallnet as jsmallnet
from isokann_tpu.optim import AdamRegularized as JAdam
from isokann_tpu.parallel import (make_mesh as jmake_mesh,
                                  replicate as jreplicate,
                                  shard_batch as jshard_batch,
                                  sharded_train_step as jsharded_train_step)
from isokann_tpu_torch._device import WalkerShard
from isokann_tpu_torch.md import langevin_kernel as LK
from isokann_tpu_torch.parallel import distributed as D
from isokann_tpu_torch.weights import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2

RANK_CODE = r'''
"""Rank-side cases of tests/test_torch_parallel.py: each returns a dict of
tensors / numbers; ``main`` runs them all in a group of WORLD ranks."""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, ROOT)
import isokann_tpu_torch as itt
from isokann_tpu_torch import parallel as P
from isokann_tpu_torch.parallel import distributed as D


def case_train(inputs):
    """One step of sharded_train_step and of shardmap_train_step."""
    out = {}
    mesh = P.make_mesh()
    for name, make in (("gspmd", P.sharded_train_step),
                       ("shardmap", P.shardmap_train_step)):
        model = itt.smallnet(2, device="cpu")
        model.load_state_dict(inputs["params"])
        P.replicate(mesh, model)
        step = make(mesh, model, itt.AdamRegularized())
        loss = step(P.shard_batch(mesh, inputs["xs"]),
                    P.shard_batch(mesh, inputs["ys"]),
                    P.shard_batch(mesh, inputs["yw"]))
        out[name] = (float(loss), {k: v.clone() for k, v in
                                   model.state_dict().items()})
    return out


def case_propagate():
    """Alanine bursts of 8 x 2 walkers (steps=5), sharded above one rank."""
    sim = itt.MDSimulation(steps=5, device="cpu")
    rng = np.random.default_rng(3)
    x0 = sim.coords[None].repeat(8, 1) + torch.as_tensor(
        rng.normal(scale=0.005, size=(8, sim.dim)), dtype=torch.float32)
    ys = sim.propagate(x0, 2, gen=itt.make_generator(7))
    return dict(ys=ys, sharded=sim._walker_mesh(16) is not None)


def case_iso():
    """Iso(shard=True).run(6) on the Doublewell, nx 40, minibatch 0 / 16."""
    out = {}
    for mb in (0, 16):
        dw = itt.Doublewell(device="cpu")
        data = itt.SimulationData.from_sim(dw, nx=40, nk=4, gen=0)
        model = itt.smallnet(1, gen=1, device="cpu")
        iso = itt.Iso(data, model=model, opt=itt.AdamRegularized(),
                      minibatch=mb, gen=2, shard=True).run(6)
        out[mb] = (list(iso.losses), {k: v.clone() for k, v in
                                      iso.model.state_dict().items()})
    return out


def case_iso_step():
    """distributed_iso_step on alanine (steps=2, 16 x 2) and the
    Doublewell (16 x 4)."""
    mesh = P.make_mesh()
    sim = itt.MDSimulation(steps=2, device="cpu")
    model = itt.pairnet(n=231, gen=0, device="cpu")
    step = P.distributed_iso_step(mesh, sim, model, itt.AdamRegularized(),
                                  nk=2)
    loss, ys = step(sim.coords[None].repeat(16, 1), gen=1)
    md = (float(loss), ys, {k: v.clone() for k, v in
                            model.state_dict().items()})
    dw = itt.Doublewell(device="cpu")
    model = itt.smallnet(1, gen=0, device="cpu")
    step = P.distributed_iso_step(mesh, dw, model, itt.AdamRegularized(),
                                  nk=4)
    loss, ys = step(dw.randx0(16, gen=3), gen=4)
    return dict(md=md, dw=(float(loss), ys))


def case_host_local():
    """host_local_batch assembles the global batch; 3 training steps."""
    mesh = P.make_mesh()
    x = torch.arange(16.0 * 3).reshape(16, 3)
    g = D.host_local_batch(mesh, x[D.process_slice(16)])
    dw = itt.Doublewell(device="cpu")
    model = itt.smallnet(1, gen=0, device="cpu")
    step = P.distributed_iso_step(mesh, dw, model, itt.AdamRegularized(),
                                  nk=2)
    x0 = torch.linspace(-1.2, 1.2, 16)[:, None]
    gen = itt.make_generator(1)
    for _ in range(3):
        loss, ys = step(x0, gen=gen)
    return dict(g=g, sum=float(g.sum()), loss=float(loss),
                ys_shape=tuple(ys.shape))


def case_pme():
    """The sharded PME training step of the JAX dryrun: padding 0.55,
    nx = 4 x world, nk = 2."""
    mesh = P.make_mesh()
    simp = itt.MDSimulation(steps=2, addwater=True, padding=0.55,
                            method="PME", device="cpu")
    nfeat = simp.featurizer(simp.coords[None]).shape[-1]
    model = itt.pairnet(n=nfeat, gen=5, device="cpu")
    step = P.distributed_iso_step(mesh, simp, model, itt.AdamRegularized(),
                                  nk=2)
    nx = 4 * mesh.size
    loss, ys = step(simp.coords[None].repeat(nx, 1), gen=6)
    return dict(loss=float(loss), ys_shape=tuple(ys.shape),
                finite=bool(torch.isfinite(ys).all()), dim=simp.dim,
                route=simp.route, natoms=simp.natoms)


def main():
    rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    bad = None
    try:
        # a rendezvous that no other rank joins: explicit arguments, so
        # its timeout raises
        D.initialize(f"file://{outdir}/lonely{rank}", world, rank,
                     device="cpu", timeout=1)
    except RuntimeError as e:
        bad = type(e).__name__
    D.initialize(f"file://{store}", world, rank, device="cpu", timeout=120)
    D.initialize(f"file://{store}", world, rank, device="cpu", timeout=120)
    inputs = torch.load(os.path.join(outdir, "inputs.pt"))
    res = dict(bad_rendezvous=bad, world=D.world_size(), rank=D.rank(),
               device_count=P.device_count(), train=case_train(inputs),
               propagate=case_propagate(), iso=case_iso(),
               iso_step=case_iso_step(), host_local=case_host_local(),
               pme=case_pme())
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    D.shutdown()
    print("RANK_OK", rank, flush=True)


if __name__ == "__main__":
    main()
'''


def _load_cases(path):
    spec = importlib.util.spec_from_file_location("torch_parallel_ranks",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def train_inputs():
    """The data and JAX parameters of case (a), from numpy seeds."""
    model = jsmallnet(2, key=jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(16, 2)).astype(np.float32)
    ys = rng.normal(size=(16, 3, 2)).astype(np.float32)
    yw = np.ones((16, 3), np.float32)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    model.params))
    return dict(jax_model=model, xs=xs, ys=ys, yw=yw, params=sd)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, train_inputs):
    """Every rank's results of ``RANK_CODE`` in a gloo group of WORLD
    ranks, and the module of cases for world size 1 here."""
    d = tmp_path_factory.mktemp("ranks")
    script = d / "ranks.py"
    script.write_text(f"ROOT = {ROOT!r}\n" + RANK_CODE)
    torch.save(dict(params=train_inputs["params"],
                    xs=torch.as_tensor(train_inputs["xs"]),
                    ys=torch.as_tensor(train_inputs["ys"]),
                    yw=torch.as_tensor(train_inputs["yw"])),
               d / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(d / "store"),
         str(d)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the gloo ranks hung; partial output: {outs}")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert f"RANK_OK {r}" in out
    res = [torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return dict(res=res, cases=_load_cases(script),
                inputs=torch.load(d / "inputs.pt"))


def _close_state(a, b, atol):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.allclose(a[k], b[k], atol=atol), (k, float(
            (a[k] - b[k]).abs().max()))


def test_ranks_up(ranks):
    """Both ranks joined one group of two (a second ``initialize`` was a
    no-op) and saw two devices; an explicit rendezvous that no other rank
    joined raised at its timeout."""
    for r, res in enumerate(ranks["res"]):
        assert (res["world"], res["rank"], res["device_count"]) == (
            WORLD, r, WORLD)
        assert res["bad_rendezvous"] is not None


def _jax_train_step(inp):
    """JAX's ``sharded_train_step`` on its 8-device virtual mesh."""
    mesh = jmake_mesh(8)
    model = inp["jax_model"]
    opt = JAdam()
    step = jsharded_train_step(mesh, model.apply, opt)
    p, _, loss = step(jreplicate(mesh, model.params),
                      jreplicate(mesh, opt.init(model.params)),
                      jshard_batch(mesh, jnp.asarray(inp["xs"])),
                      jshard_batch(mesh, jnp.asarray(inp["ys"])),
                      jshard_batch(mesh, jnp.asarray(inp["yw"])),
                      jax.random.PRNGKey(0))
    return float(loss), state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, p))


@pytest.mark.parametrize("world", [1, WORLD])
@pytest.mark.parametrize("name", ["gspmd", "shardmap"])
def test_train_steps_match_jax(ranks, train_inputs, world, name):
    """(a) sharded_train_step / shardmap_train_step at world sizes 1 and 2
    against JAX's sharded step on its 8-device mesh, the same parameters
    and data: loss rel 1e-5, parameters atol 1e-5."""
    loss_j, params_j = _jax_train_step(train_inputs)
    if world == 1:
        got = [ranks["cases"].case_train(ranks["inputs"])]
    else:
        got = [res["train"] for res in ranks["res"]]
    for g in got:
        loss, params = g[name]
        assert loss == pytest.approx(loss_j, rel=1e-5)
        _close_state(params, params_j, 1e-5)


def test_propagate_two_ranks_equal_one(ranks):
    """(b) MDSimulation.propagate sharded over two ranks equals the
    unsharded run for the same generator (atol 1e-5), on both ranks."""
    one = ranks["cases"].case_propagate()
    assert not one["sharded"]
    for res in ranks["res"]:
        assert res["propagate"]["sharded"]
        assert res["propagate"]["ys"].shape == (8, 2, 66)
        assert torch.allclose(res["propagate"]["ys"], one["ys"], atol=1e-5)


@pytest.mark.parametrize("mb", [0, 16])
def test_iso_shard_equals_unsharded(ranks, mb):
    """(c) Iso(shard=True).run(6) over two ranks equals shard=False, nx 40
    (bucket 48): losses rtol 1e-4 atol 1e-6, parameters atol 1e-4."""
    dw = itt.Doublewell(device="cpu")
    data = itt.SimulationData.from_sim(dw, nx=40, nk=4, gen=0)
    iso = itt.Iso(data, model=itt.smallnet(1, gen=1, device="cpu"),
                  opt=itt.AdamRegularized(), minibatch=mb, gen=2,
                  shard=False).run(6)
    ref = dict(iso.model.state_dict())
    for res in ranks["res"]:
        losses, params = res["iso"][mb]
        assert np.allclose(losses, iso.losses, rtol=1e-4, atol=1e-6)
        _close_state(params, ref, 1e-4)


def test_distributed_iso_step_two_ranks_equal_one(ranks):
    """(d) distributed_iso_step on alanine (steps=2, 16 x 2) and the
    Doublewell (16 x 4): finite losses, the shapes of JAX's tests, and
    two ranks equal to one for the same seed (atol 1e-5)."""
    one = ranks["cases"].case_iso_step()
    assert one["md"][1].shape == (16, 2, 66)
    assert one["dw"][1].shape == (16, 4, 1)
    for res in ranks["res"]:
        loss, ys, params = res["iso_step"]["md"]
        assert np.isfinite(loss) and ys.shape == (16, 2, 66)
        assert loss == pytest.approx(one["md"][0], abs=1e-5)
        assert torch.allclose(ys, one["md"][1], atol=1e-5)
        _close_state(params, one["md"][2], 1e-5)
        loss, ys = res["iso_step"]["dw"]
        assert np.isfinite(loss) and ys.shape == (16, 4, 1)
        assert loss == pytest.approx(one["dw"][0], abs=1e-5)
        assert torch.allclose(ys, one["dw"][1], atol=1e-5)


def test_host_local_batch_and_consistent_loss(ranks):
    """(e) host_local_batch assembles the global batch (its sum exact),
    and after 3 training steps the loss is identical on both ranks."""
    x = torch.arange(16.0 * 3).reshape(16, 3)
    res = ranks["res"]
    for r in res:
        assert torch.equal(r["host_local"]["g"], x)
        assert r["host_local"]["sum"] == float(x.sum())
        assert r["host_local"]["ys_shape"] == (16, 2, 1)
        assert np.isfinite(r["host_local"]["loss"])
    assert res[0]["host_local"]["loss"] == res[1]["host_local"]["loss"]


def test_initialize_noop_and_idempotent(monkeypatch):
    """(f) initialize is a no-op without a launcher and with
    num_processes=1; no group comes up."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    D.initialize()
    D.initialize(num_processes=1)
    D.initialize("localhost:1", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    assert D.world_size() == 1 and D.rank() == 0
    assert itt.parallel.device_count() == 1


@pytest.mark.parametrize("n", [0, 7, 8, 100])
def test_process_slice_matches_jax_formula(monkeypatch, n):
    """(f) process_slice is JAX's [start, stop) split for world sizes 1-4,
    and the slices tile [0, n)."""
    for world in (1, 2, 3, 4):
        got = []
        for r in range(world):
            monkeypatch.setattr(D, "world_size", lambda w=world: w)
            monkeypatch.setattr(D, "rank", lambda r=r: r)
            per, rem = n // world, n % world
            start = r * per + min(r, rem)
            want = slice(start, start + per + (1 if r < rem else 0))
            assert D.process_slice(n) == want
            got.extend(range(n)[D.process_slice(n)])
        assert got == list(range(n))


def test_sharded_pme_training_step(ranks):
    """(g) the JAX dryrun's sharded PME training step (padding 0.55, nx =
    4 x world): finite loss, finite bursts of the expected shape."""
    for res in ranks["res"]:
        p = res["pme"]
        assert p["route"] == "dense"
        assert np.isfinite(p["loss"]) and p["finite"]
        assert p["ys_shape"] == (4 * WORLD, 2, p["dim"])
    assert ranks["res"][0]["pme"]["loss"] == ranks["res"][1]["pme"]["loss"]


@pytest.mark.parametrize("cut", [4, 8, 12])
def test_plain_walker_offset_equals_whole_batch(cut):
    """(h) kernel A's plain version, launched on rows [0, cut) and [cut,
    16) as ``WalkerShard``s of the 16 walkers, equals one launch of the 16
    (the host noise of the whole batch, each launch keeping its rows; other
    noise would move v by ~1 nm/ps).  Not bit for bit: the CPU's vector
    loops round a batch of 4 or 12 rows otherwise than one of 16."""
    sim = itt.MDSimulation(steps=5, device="cpu")
    rng = np.random.default_rng(1)
    x = sim.coords[None].repeat(16, 1) + torch.as_tensor(
        rng.normal(scale=0.01, size=(16, sim.dim)), dtype=torch.float32)
    v = sim.random_velocities(itt.make_generator(1), x.shape)
    whole = LK.langevin_middle_plain(sim.plan, x, v, 5,
                                     itt.make_generator(3))
    a = LK.langevin_middle(sim.plan, x[:cut], v[:cut], 5,
                           WalkerShard(itt.make_generator(3), 0, 16))
    b = LK.langevin_middle(sim.plan, x[cut:], v[cut:], 5,
                           WalkerShard(itt.make_generator(3), cut, 16),
                           walker_offset=cut)
    for k in (0, 1):
        assert torch.allclose(torch.cat([a[k], b[k]]), whole[k], rtol=0,
                              atol=1e-5)


def test_plain_walker_offset_needs_the_whole_batch():
    """The plain version cannot tell a shard's rows without the whole
    batch: a nonzero ``walker_offset`` with a bare generator raises, and
    so does one that is not its ``WalkerShard``'s start."""
    sim = itt.MDSimulation(steps=1, device="cpu")
    x = sim.coords[None].repeat(4, 1)
    v = torch.zeros_like(x)
    with pytest.raises(ValueError, match="WalkerShard"):
        LK.langevin_middle(sim.plan, x, v, 1, itt.make_generator(3),
                           walker_offset=4)
    with pytest.raises(ValueError, match="start"):
        LK.langevin_middle(sim.plan, x, v, 1,
                           WalkerShard(itt.make_generator(3), 4, 8),
                           walker_offset=2)


def test_foreign_gloo_group_names_no_cpu_device(tmp_path):
    """A gloo group that ``initialize`` did not bring up has no known
    device: the mesh raises instead of assuming the CPU, and a device
    pinned with ``set_default_devices`` is taken."""
    import datetime
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(RuntimeError, match="set_default_devices"):
            itt.parallel.default_devices()
        itt.parallel.set_default_devices(["cpu"])
        assert itt.parallel.make_mesh().device == torch.device("cpu")
    finally:
        itt.parallel.set_default_devices(None)
        dist.destroy_process_group()


def test_parallel_exports_match_jax():
    """The port's ``parallel`` exports every public name of the JAX
    package's, and is reachable from the package."""
    import isokann_tpu.parallel as jp
    import isokann_tpu.parallel.distributed as jd
    import isokann_tpu.parallel.mesh as jm
    import isokann_tpu_torch.parallel as tp
    names = {n for n in dir(jp) if not n.startswith("_")} - {
        "mesh", "distributed"}
    assert names and {n for n in names if not hasattr(tp, n)} == set()
    for jmod, tmod in ((jm, tp.mesh), (jd, tp.distributed)):
        public = {n for n, v in vars(jmod).items() if not n.startswith("_")
                  and callable(v) and getattr(v, "__module__", "")
                  == jmod.__name__}
        assert {n for n in public if not hasattr(tmod, n)} == set()
    assert itt.parallel is tp
