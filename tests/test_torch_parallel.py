"""The port's parallel/ (torch.distributed) against the JAX package's
parallel/ (shard_map), on the CPU.

The JAX functions run on meshes of the first 4 of the 8 virtual CPU
devices that tests/conftest.py makes, each program compiled by XLA at its
CPU optimization level 0.  The port runs on a gloo world of 4 ranks
started once for the module (``launch.spawn`` of ``launch.run_calls``: every
case one SPMD call, global inputs sharded in the rank as JAX's in_specs
shard them), and on a world of 1 rank for the self-pair path.  Per-rank
results are concatenated along the leading dimension, as JAX's out_specs
P(axis) concatenate the devices' blocks.

Tolerances: meshes, shards, ppermute, psum (of int32: a float sum's
rounding depends on the reduction's order), all_gather and all_to_all
exact; pmean within 1e-6; decoded bits, ok and CRC flags and the success
counts equal; the subcarrier-sharded receiver's codeword LLRs, at 4 ranks
and at 1, within 1e-5 of max|LLR| of JAX's block function run on the
whole band.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openairinterface5g_tpu.coding import ldpc as jldpc
from openairinterface5g_tpu.models import pusch as jpusch
from openairinterface5g_tpu.parallel import pusch_sp as jsp
from openairinterface5g_tpu.parallel import sharded as jsh
from openairinterface5g_tpu.parallel.mesh import make_mesh as jmake_mesh
from openairinterface5g_tpu.parallel.mesh import make_mesh_2d as jmake_mesh_2d
from openairinterface5g_tpu.parallel.mesh import shard_batch as jshard_batch
from openairinterface5g_tpu.phy import channel_estimation as jce
from openairinterface5g_tpu.phy import llr as jllr
from openairinterface5g_tpu.phy import ofdm as jofdm
from openairinterface5g_tpu.phy import refsig as jrefsig
from openairinterface5g_tpu.phy import scrambling as jscr
from openairinterface5g_tpu_torch.coding import ldpc as tldpc
from openairinterface5g_tpu_torch.convert import config_from_jax
from openairinterface5g_tpu_torch.models.pusch import PuschConfig, pusch_tx
from openairinterface5g_tpu_torch.parallel import collectives as tc
from openairinterface5g_tpu_torch.parallel import dryrun, launch, multihost
from openairinterface5g_tpu_torch.parallel import mesh as tmesh
from openairinterface5g_tpu_torch.parallel import pusch_sp as tsp
from openairinterface5g_tpu_torch.parallel import sharded as tsh
from openairinterface5g_tpu_torch.parallel.launch import MESH, Call, Shard

torch.set_num_threads(1)   # one intra-op thread: the test workers share the host's cores

N = 4                      # ranks, and JAX devices
PMEAN_TOL = 1e-6
LLR_TOL = 1e-5             # of max |LLR|


def _compiled(fn, *args):
    """fn compiled by XLA at its CPU backend's optimization level 0, called
    on args."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _jmesh(shape=(N,), names=("i",)) -> Mesh:
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


def _cat(res):
    """Per-rank results -> one array, concatenated along the leading dim."""
    return np.concatenate([np.asarray(r) for r in res], axis=0)


# ---- inputs, made once from seeded numpy; both packages take the same ----

RNG = np.random.default_rng(14)
X = RNG.standard_normal((N, 3, 5)).astype(np.float32)
XC = (RNG.standard_normal((N, 3, 5)) + 1j * RNG.standard_normal((N, 3, 5))).astype(np.complex64)
XA = RNG.standard_normal((N, N, 6)).astype(np.float32)
XT = (RNG.standard_normal((N, 2 * N, 6))
      + 1j * RNG.standard_normal((N, 2 * N, 6))).astype(np.complex64)
XI = RNG.integers(-1000, 1000, (N, 3, 5)).astype(np.int32)   # sums exact in any order
Y8 = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)

# the collectives: name -> (port function, mesh shape, names, axis, global
# input, kwargs of both, the jax.lax function)
RING = [(i, (i - 1) % N) for i in range(N)]
PARTIAL = [(0, 2), (2, 0), (1, 3)]            # rank 1 receives nothing: zeros
COLLECTIVES = {
    "psum": (tc.psum, (N,), ("i",), "i", XI, {}, jax.lax.psum),
    "pmean": (tc.pmean, (N,), ("i",), "i", X, {}, jax.lax.pmean),
    "ppermute ring, complex": (tc.ppermute, (N,), ("i",), "i", XC, {"perm": RING},
                               jax.lax.ppermute),
    "ppermute partial": (tc.ppermute, (N,), ("i",), "i", X, {"perm": PARTIAL},
                         jax.lax.ppermute),
    "all_gather stacked": (tc.all_gather, (N,), ("i",), "i", X, {}, jax.lax.all_gather),
    "all_gather tiled dim 2, complex": (tc.all_gather, (N,), ("i",), "i", XC,
                                        {"axis_dim": 2, "tiled": True}, jax.lax.all_gather),
    "all_to_all": (tc.all_to_all, (N,), ("i",), "i", XA,
                   {"split_axis": 1, "concat_axis": 0}, jax.lax.all_to_all),
    "all_to_all tiled, complex": (tc.all_to_all, (N,), ("i",), "i", XT,
                                  {"split_axis": 1, "concat_axis": 2, "tiled": True},
                                  jax.lax.all_to_all),
    "psum over cb of (dp, cb)": (tc.psum, (2, 2), ("dp", "cb"), "cb", XI, {}, jax.lax.psum),
    "all_gather over (dp, cb)": (tc.all_gather, (2, 2), ("dp", "cb"), ("dp", "cb"), X,
                                 {"tiled": True}, jax.lax.all_gather),
}
_JAX_KW = {"axis_dim": "axis", "split_axis": "split_axis", "concat_axis": "concat_axis",
           "tiled": "tiled", "perm": "perm"}

# sharded_ldpc_decode: BG2 Z = 64, 16 code blocks, clean and at a noise
# level that leaves some code blocks failing
JG = jldpc.build_graph(2, 64)
TG = tldpc.build_graph(2, 64)
INFO = RNG.integers(0, 2, (16, JG.K)).astype(np.int8)
CW = np.asarray(jldpc.encode(JG, jnp.asarray(INFO))).astype(np.float32)


def _decode_llrs(sigma: float) -> np.ndarray:
    if sigma == 0:
        llr = (1.0 - 2.0 * CW) * 6.0
    else:
        y = (1.0 - 2.0 * CW) + sigma * np.random.default_rng(7).standard_normal(CW.shape)
        llr = 2.0 * y / sigma ** 2
    llr = llr.astype(np.float32)
    llr[:, :2 * JG.Z] = 0
    return llr


DECODE_SIGMAS = (0.0, 1.28)


# the subcarrier-sharded receiver: 1 layer MRC and 2 layers MMSE
SP_CFGS = {"1 layer": jpusch.PuschConfig(mu=1, n_prb=16, mcs=16, n_layers=1, n_rx=1),
           "2 layers": jpusch.PuschConfig(mu=1, n_prb=8, mcs=16, n_layers=2, n_rx=2)}


def _sp_grid(jcfg) -> tuple:
    """(TB bits, received RE grid) as numpy: a 2x2 (1x1) channel linear in
    the subcarrier, so the halo carries another value than its block's
    edge; 1 layer with noise 0.02 on each RE, 2 layers without, so that
    the pmean'd noise variance (the pair differences' mean, constant
    along a linear channel) is the same at any number of blocks."""
    rng = np.random.default_rng(jcfg.n_layers)
    tb = rng.integers(0, 2, (2, jcfg.tbs)).astype(np.int8)
    grid = _compiled(lambda t: jofdm.extract_from_grid(jcfg.fp, jofdm.ofdm_demodulate(
        jcfg.fp, jpusch.pusch_tx(jcfg, t)[0], jcfg.slot)), jnp.asarray(tb))
    shape = (2, jcfg.n_rx, jcfg.n_layers, 1)
    h0, h1 = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
    h = h0 + h1 * np.arange(12 * jcfg.n_prb) / (12 * jcfg.n_prb)      # (R, L, n_sc)
    rx = np.einsum("rlk,blsk->brsk", h, np.asarray(grid))
    if jcfg.n_layers == 1:
        rx = rx + 0.02 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return tb, rx.astype(np.complex64)


SP_INPUTS = {k: _sp_grid(c) for k, c in SP_CFGS.items()}

# the slot sweep: 6 PRB, MCS 4, 1x1, one trial per rank
SWEEP_CFG = jpusch.PuschConfig(mu=1, n_prb=6, mcs=4, n_layers=1, n_rx=1,
                               decoder_backend="xla")
SWEEP_TB = RNG.integers(0, 2, (N, SWEEP_CFG.tbs)).astype(np.int8)
SWEEP_SNRS = (20.0, -10.0)

# the dry run at 24 PRB: JAX's configurations at the width the tests take
DRY_CFGS = {name: dict(cfg, n_prb=24) for name, cfg in
            (("dp", dryrun.DP_CFG), ("sp", dryrun.SP_CFG), ("dpcb", dryrun.DPCB_CFG))}


def _calls() -> dict:
    """Every case of the 4-rank world, by name."""
    calls = {}
    for name, (fn, shape, names, axis, x, kw, _) in COLLECTIVES.items():
        shard = names if len(names) > 1 else names[0]       # JAX's in_specs below
        calls[name] = Call(fn, shape, names, (Shard(torch.as_tensor(x), shard), MESH, axis), kw)
    calls["shard 1-D"] = Call(tmesh.shard_batch, (N,), ("dp",), (MESH, torch.as_tensor(Y8)))
    for axis in ("dp", ("dp", "cb")):
        calls[f"shard {axis}"] = Call(tmesh.shard_batch, (2, 2), ("dp", "cb"),
                                      (MESH, torch.as_tensor(Y8), axis))
    for axis in ("dp", "cb"):
        calls[f"index {axis}"] = Call(tmesh.axis_index, (2, 2), ("dp", "cb"), (MESH, axis))
    for sigma in DECODE_SIGMAS:
        calls[f"decode {sigma}"] = Call(
            tsh.sharded_ldpc_decode, (N,), ("dp",),
            (MESH, TG, Shard(torch.as_tensor(_decode_llrs(sigma)))), {"n_iters": 8})
    for key, jcfg in SP_CFGS.items():
        calls[f"sp {key}"] = Call(tsp.pusch_rx_subcarrier_sharded, (N,), ("sp",),
                                  (MESH, config_from_jax(jcfg),
                                   torch.tensor(SP_INPUTS[key][1])), {"n_iters": 10})
    gen = torch.Generator()
    gen.manual_seed(0)
    for snr in SWEEP_SNRS:
        calls[f"sweep {snr}"] = Call(
            tsh.sharded_slot_sweep, (N,), ("dp",),
            (MESH, config_from_jax(SWEEP_CFG), snr, Shard(torch.as_tensor(SWEEP_TB)), gen),
            {"n_iters": 8})
    calls["dryrun"] = Call(dryrun.dryrun_multichip, (N,), ("dp",), (None, DRY_CFGS, 0))
    return calls


def _calls_1() -> dict:
    """The 1-rank world: the self pair, the collectives at one rank, the
    subcarrier-sharded receiver unsharded."""
    calls = {"ppermute self": Call(tc.ppermute, (1,), ("i",),
                                   (torch.as_tensor(XC[:1]), MESH, "i", [(0, 0)])),
             "all_gather": Call(tc.all_gather, (1,), ("i",),
                                (torch.as_tensor(X[:1]), MESH, "i")),
             "all_to_all": Call(tc.all_to_all, (1,), ("i",),
                                (torch.as_tensor(XT[:1]), MESH, "i", 1, 2, True)),
             "psum": Call(tc.psum, (1,), ("i",), (torch.as_tensor(X[:1]), MESH, "i"))}
    for key, jcfg in SP_CFGS.items():
        calls[f"sp {key}"] = Call(tsp.pusch_rx_subcarrier_sharded, (1,), ("sp",),
                                  (MESH, config_from_jax(jcfg),
                                   torch.tensor(SP_INPUTS[key][1])), {"n_iters": 10})
    return calls


def _world(calls: dict, world: int) -> dict:
    per_rank = launch.spawn(launch.run_calls, world, "cpu", (list(calls.values()),))
    return {name: [r[i] for r in per_rank] for i, name in enumerate(calls)}


@pytest.fixture(scope="module")
def four():
    """name -> the 4 ranks' results."""
    return _world(_calls(), N)


@pytest.fixture(scope="module")
def one():
    """name -> the 1 rank's result."""
    return {k: v[0] for k, v in _world(_calls_1(), 1).items()}


# ---- (a) meshes and shards ----

def test_mesh_rank_order_matches_jax(four):
    """Rank r sits where JAX's make_mesh_2d puts device r (row-major)."""
    devs = jmake_mesh_2d(2, 2).devices
    for r in range(N):
        dp, cb = (int(v[0]) for v in np.nonzero(devs == jax.devices()[r]))
        assert (four["index dp"][r], four["index cb"][r]) == (dp, cb)


@pytest.mark.parametrize("name,mesh,spec", [
    ("shard 1-D", "1d", P("dp")), ("shard dp", "2d", P("dp")),
    ("shard ('dp', 'cb')", "2d", P(("dp", "cb")))])
def test_shard_batch_matches_jax(four, name, mesh, spec):
    m = jmake_mesh(N) if mesh == "1d" else jmake_mesh_2d(2, 2)
    placed = (jshard_batch(m, jnp.asarray(Y8)) if mesh == "1d"
              else jax.device_put(jnp.asarray(Y8), NamedSharding(m, spec)))
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for r in range(N):
        np.testing.assert_array_equal(four[name][r].numpy(), by_device[jax.devices()[r]])


# ---- (b) the collectives ----

@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_matches_jax(four, name):
    _, shape, names, axis, x, kw, jfn = COLLECTIVES[name]
    jkw = {_JAX_KW[k]: v for k, v in kw.items()}
    spec = P(names if len(names) > 1 else names[0])
    f = shard_map(lambda b: jfn(b, axis, **jkw), mesh=_jmesh(shape, names),
                  in_specs=(spec,), out_specs=spec, check_vma=False)
    want = np.asarray(_compiled(f, jnp.asarray(x)))
    got = _cat([r.numpy() for r in four[name]])
    assert got.dtype == want.dtype and got.shape == want.shape
    if name == "pmean":
        assert np.abs(got - want).max() <= PMEAN_TOL
    else:
        np.testing.assert_array_equal(got, want)


def test_collectives_at_one_rank(one):
    """The self pair is a local copy; a 1-rank gather, all-to-all and sum
    return their input as JAX's do."""
    np.testing.assert_array_equal(one["ppermute self"].numpy(), XC[:1])
    np.testing.assert_array_equal(one["all_gather"].numpy(), X[:1][None])
    np.testing.assert_array_equal(one["all_to_all"].numpy(), XT[:1])
    np.testing.assert_array_equal(one["psum"].numpy(), X[:1])


# ---- (c) the sharded decode ----

@pytest.mark.parametrize("sigma", DECODE_SIGMAS)
def test_sharded_ldpc_decode_matches_jax(four, sigma):
    llr = _decode_llrs(sigma)
    bits, ok = _compiled(lambda x: jsh.sharded_ldpc_decode(jmake_mesh(N), JG, x, n_iters=8),
                         jnp.asarray(llr))
    bits, ok = np.asarray(bits), np.asarray(ok)
    np.testing.assert_array_equal(_cat([b.numpy() for b, _ in four[f"decode {sigma}"]]), bits)
    for _, got_ok in four[f"decode {sigma}"]:            # the whole verdict on every rank
        np.testing.assert_array_equal(got_ok.numpy(), ok)
    if sigma == 0:
        assert ok.all()
        np.testing.assert_array_equal(bits, INFO)
    else:
        assert 0 < ok.sum() < len(ok)


# ---- (d) the subcarrier-sharded receiver ----

@pytest.mark.parametrize("key", list(SP_CFGS))
def test_subcarrier_sharded_rx_matches_jax(four, key):
    jcfg = SP_CFGS[key]
    tb, grid = SP_INPUTS[key]
    want = _compiled(lambda g: jsp.pusch_rx_subcarrier_sharded(jmake_mesh(N, "sp"), jcfg, g,
                                                               n_iters=10), jnp.asarray(grid))
    for got in four[f"sp {key}"]:                       # whole on every rank
        for field in ("tb_bits", "tb_ok", "cb_ok"):
            np.testing.assert_array_equal(got[field].numpy(), np.asarray(want[field]))
    assert np.asarray(want["tb_ok"]).all()
    np.testing.assert_array_equal(np.asarray(want["tb_bits"]), tb)


def _one_block_llrs(jcfg, grid: np.ndarray) -> np.ndarray:
    """JAX's block function (pusch_sp.py:65-113) on the whole band, one
    block whose last pilot holds (no right neighbour), descrambled: the
    codeword LLRs the sharded receivers must gather."""
    qm = jcfg.qm_rate[0]
    pil = jrefsig.dmrs_sequence(jrefsig.dmrs_cinit(jcfg.slot, jcfg.dmrs_symbols[0], jcfg.n_id),
                                6 * jcfg.n_prb)

    def f(g):
        ls = jce.ls_estimate(g[:, :, jcfg.dmrs_symbols[0], ::2], pil)
        y = g[:, :, jnp.asarray(jcfg.data_symbols), :]
        if jcfg.n_layers == 1:
            mid = 0.5 * (ls + jnp.concatenate([ls[..., 1:], ls[..., -1:]], axis=-1))
            h = jnp.stack([ls, mid], axis=-1).reshape(*ls.shape[:-1], -1)
            x = jnp.sum(jnp.conj(h)[:, :, None, :] * y, axis=1)
            lv = jllr.llrs(x, jnp.broadcast_to(jnp.sum(jnp.abs(h) ** 2, axis=1)[:, None],
                                               x.shape), qm)
        else:
            hc = jnp.stack([0.5 * (ls[..., 0::2] + ls[..., 1::2]),
                            0.5 * (ls[..., 0::2] - ls[..., 1::2])], axis=2)
            nvar = jnp.mean(jnp.abs(hc[..., 1:] - hc[..., :-1]) ** 2, axis=(1, 2, 3))
            mid = 0.5 * (hc + jnp.concatenate([hc[..., 1:], hc[..., -1:]], axis=-1))
            h = jnp.stack([hc, hc, mid, mid], axis=-1).reshape(*hc.shape[:-1], -1)
            x, mag = jpusch._mmse_over_syms(h, y, nvar)
            lv = jllr.llrs(x, mag, qm).reshape(*x.shape[:3], -1, qm)
            lv = lv.transpose(0, 2, 3, 1, 4)
        return jscr.scramble_llrs(lv.reshape(g.shape[0], -1),
                                  jscr.pusch_cinit(jcfg.rnti, 0, jcfg.n_id))

    return np.asarray(_compiled(f, jnp.asarray(grid)))


@pytest.mark.parametrize("key", list(SP_CFGS))
def test_subcarrier_sharded_llrs_match_one_block(four, one, key):
    """The halo seams and the held band edge: 4 blocks and 1 give the
    codeword LLRs of JAX's block function on the whole band."""
    want = _one_block_llrs(SP_CFGS[key], SP_INPUTS[key][1])
    scale = np.abs(want).max()
    for got in [one[f"sp {key}"], *four[f"sp {key}"]]:
        assert np.abs(got["llrs"].numpy() - want).max() <= LLR_TOL * scale


# ---- (e) the slot sweep ----

@pytest.mark.parametrize("snr", SWEEP_SNRS)
def test_sharded_slot_sweep_matches_jax(four, snr):
    ok, total = _compiled(lambda t: jsh.sharded_slot_sweep(
        jmake_mesh(N), SWEEP_CFG, snr, t, jax.random.PRNGKey(0), n_iters=8),
        jnp.asarray(SWEEP_TB))
    got = four[f"sweep {snr}"]
    np.testing.assert_array_equal(_cat([o.numpy() for o, _ in got]), np.asarray(ok))
    for _, got_total in got:
        assert int(got_total) == int(total)
    assert int(total) == (N if snr > 0 else 0)


# ---- (f) the dry run ----

def test_dryrun_multichip_at_24_prb(four):
    """Every TB and code block of the three phases passes; dp x cb's bits
    equal JAX's ldpc.decode on the same flat LLRs."""
    runs = [r for r in four["dryrun"]]
    for run in runs:
        dp, sp, dpcb = (run[k]["out"] for k in ("dp", "sp", "dpcb"))
        assert dp["n_ok"] == N and bool(dp["tb_ok"].all())
        assert torch.equal(dp["tb_bits"], dp["tb_sent"])
        assert sp["n_sp"] == N and bool(sp["tb_ok"].all())
        assert torch.equal(sp["tb_bits"], sp["tb_sent"])
        assert bool(dpcb["cb_ok"].all())
    cfg = PuschConfig(**DRY_CFGS["dpcb"])
    p, _ = cfg.seg_params()
    assert runs[0]["dpcb"]["out"]["cb_ok"].numel() == N * p.C
    llr = np.concatenate([r["dpcb"]["out"]["llr"].numpy() for r in runs])
    g = jldpc.build_graph(p.bg, p.Z)
    want = _compiled(lambda x: jldpc.decode(g, x, n_iters=dryrun.N_ITERS, early_stop=False)[0],
                     jnp.asarray(llr))
    np.testing.assert_array_equal(
        np.concatenate([r["dpcb"]["out"]["bits"].numpy() for r in runs]), np.asarray(want))


# ---- (g) no card: the card's paths raise ----

def test_card_paths_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.init_multihost("localhost:1", 1, 0, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        launch.spawn(launch.run_calls, 1, "cuda", ([],))
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()


def test_a_rank_that_raises_fails_spawn():
    """Rank 0 raises (a 4-layer configuration on the sp path) while rank 1
    waits for it in a psum: spawn ends rank 1 and raises rank 0's error,
    whichever rank's failure it sees first."""
    bad = config_from_jax(dataclasses.replace(SP_CFGS["2 layers"], n_layers=4, n_rx=4))
    calls = [Call(tsp.pusch_rx_subcarrier_sharded, (1,), ("sp",),
                  (MESH, bad, torch.tensor(SP_INPUTS["2 layers"][1]))),
             Call(tc.psum, (2,), ("i",), (torch.ones(3), MESH, "i"))]
    with pytest.raises(RuntimeError, match="rank0 raised first(.|\n)*MRC"):
        launch.spawn(launch.run_calls, 2, "cpu", (calls,))


def test_init_multihost_is_a_noop_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    multihost.init_multihost(device="cpu")
    assert not torch.distributed.is_initialized()


def test_entry_on_the_cpu():
    """entry(): the 24-PRB 2x2 receiver over complex64 IQ slots, as JAX's;
    a transmitted batch decodes."""
    fn, (example,) = dryrun.entry("cpu")
    cfg = PuschConfig(mu=1, n_prb=24, mcs=9, n_layers=2, n_rx=2)
    assert example.dtype == torch.complex64
    assert example.shape == (2, 2, cfg.fp.samples_per_slot(cfg.slot))
    tb = torch.as_tensor(np.random.default_rng(3).integers(0, 2, (2, cfg.tbs), dtype=np.int8))
    bits, ok = fn(pusch_tx(cfg, tb)[0])
    assert bool(ok.all()) and torch.equal(bits, tb)
