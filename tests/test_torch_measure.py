"""The port's measurement toolchain (``repro_torch.utils.roofline``,
``configs.shapes``, ``utils.cost``, ``launch.env``, ``launch.dryrun``)
against the JAX package's, on the CPU.

- ``active_params`` and ``model_flops_estimate`` equal JAX's exactly for
  all ten archs; the roofline terms are JAX's expressions with the H100's
  constants in place of v5e's.
- ``param_count_estimate`` and ``replica_footprint_bytes`` (params, with
  and without sgd state) equal JAX's ``jax.eval_shape`` counts for all ten
  archs at full width and depth: the port builds them on ``meta``.
- ``input_specs``, ``supports_shape`` and ``_auto_microbatches`` as in
  ``tests/test_launch.py``; ``profile_env``, ``find_tcmalloc`` and the
  re-exec guard as in ``tests/test_launch_env.py``, for the profiles the
  port keeps.
- ``cost_of``: flops equal the analytic count; each kernel's ``cost`` is
  counted once per wrapper call on ``meta`` and on the CPU, in place of
  its plain version's arithmetic; the dry run's ``run_one`` at
  ``smoke_variant`` size for one arch per mixer.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import os
import sys

import pytest
import torch

import repro.configs as jconfigs
import repro.configs.shapes as jshapes
import repro.utils.roofline as jroof
from repro.launch import dryrun as jdryrun
from repro.launch import env as jenv
from repro.optim import sgd as jsgd

import repro_torch.configs as tconfigs
import repro_torch.configs.shapes as tshapes
import repro_torch.utils.roofline as troof
from repro_torch.kernels import (
    cohort_gather_scatter,
    dp_clip_noise,
    flash_attention,
    mamba2_ssd,
    quantize_decompress,
    rwkv6_scan,
)
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import env as tenv
from repro_torch.optim import sgd as tsgd
from repro_torch.utils.cost import cost_analysis_dict, cost_of

ARCHS = list(jconfigs.ASSIGNED_ARCHS)


# ------------------------------ roofline ------------------------------------

def test_h100_constants():
    assert troof.HBM_BW == 3.35e12
    assert troof.PEAK_FLOPS_BF16 == 989e12
    assert troof.PEAK_FLOPS_F32 == 67e12
    assert troof.NVLINK_BW == 450e9
    assert troof.peak_flops(torch.bfloat16) == troof.PEAK_FLOPS_BF16
    assert troof.peak_flops("float32") == troof.PEAK_FLOPS_F32
    with pytest.raises(ValueError):
        troof.peak_flops("int8")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("terms", [
    dict(flops=197e12, hbm_bytes=819e9 / 2, coll_bytes=50e9 * 3,
         model_flops=197e12 * 256 * 0.5, chips=256),
    dict(flops=3.1e9, hbm_bytes=7.7e8, coll_bytes=0.0, model_flops=2e9),
    dict(flops=0.0, hbm_bytes=1.0, coll_bytes=0.0),
])
def test_roofline_terms_are_jax_expressions_with_h100_constants(terms,
                                                                dtype):
    j = jroof.RooflineTerms(**terms, coll_breakdown={"all-reduce": 1.0})
    t = troof.RooflineTerms(**terms, coll_breakdown={"all-reduce": 1.0},
                            dtype=dtype)
    jd, td = j.as_dict(), t.as_dict()
    assert list(td) == list(jd)
    peak = troof.peak_flops(dtype)
    assert t.t_compute == j.flops / peak
    assert t.t_memory == j.hbm_bytes / 3.35e12
    assert t.t_collective == j.coll_bytes / 450e9
    # v5e's terms, rescaled to the H100's constants
    assert t.t_compute == pytest.approx(j.t_compute * jroof.PEAK_FLOPS_BF16
                                        / peak, rel=1e-15)
    assert t.t_memory == pytest.approx(j.t_memory * jroof.HBM_BW / 3.35e12,
                                       rel=1e-15)
    for key in ("flops_per_device", "hbm_bytes_per_device",
                "coll_bytes_per_device", "model_flops",
                "useful_flops_fraction", "chips", "coll_breakdown"):
        assert td[key] == jd[key], key
    terms3 = {"compute": t.t_compute, "memory": t.t_memory,
              "collective": t.t_collective}
    assert td["bottleneck"] == max(terms3, key=terms3.get)


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_equal_jax(arch):
    jc, tc = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for n in (42e9, 1.0e9 + 0.5, float(jshapes.SHAPES["train_4k"].seq_len)):
        assert troof.active_params(tc, n) == jroof.active_params(jc, n)
    for kind in ("train", "prefill", "decode"):
        assert (troof.model_flops_estimate(3.7e9, 1_048_576, kind)
                == jroof.model_flops_estimate(3.7e9, 1_048_576, kind))


# ------------------------------ shapes --------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_jax_eval_shape(arch):
    """Full width and depth, on meta (nothing allocated)."""
    jc, tc = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert (tshapes.param_count_estimate(tc)
            == jshapes.param_count_estimate(jc))
    assert (tshapes.replica_footprint_bytes(tc)
            == jshapes.replica_footprint_bytes(jc))
    assert (tshapes.replica_footprint_bytes(tc, optimizer=tsgd(0.1))
            == jshapes.replica_footprint_bytes(jc, optimizer=jsgd(0.1)))


def test_shapes_and_input_specs_equal_jax():
    assert tshapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for name, shape in tshapes.SHAPES.items():
        j = jshapes.get_shape(name)
        assert (shape.seq_len, shape.global_batch, shape.kind) == (
            j.seq_len, j.global_batch, j.kind)
        assert tshapes.needs_subquadratic(shape) == \
            jshapes.needs_subquadratic(j)
        for arch in ARCHS:
            assert (tshapes.supports_shape(tconfigs.get_arch(arch), shape)
                    == jshapes.supports_shape(jconfigs.get_arch(arch), j))
    # tests/test_launch.py:44-56
    cfg = tconfigs.get_arch("gemma3-4b")
    tr = tshapes.input_specs(cfg, tshapes.get_shape("train_4k"),
                             n_clients=4, tau=2)
    assert tr["tokens"].shape == (4, 2, 64, 4096)
    assert tr["tokens"].device.type == "meta"
    pf = tshapes.input_specs(cfg, tshapes.get_shape("prefill_32k"))
    assert pf["tokens"].shape == (32, 32768)
    dc = tshapes.input_specs(cfg, tshapes.get_shape("decode_32k"))
    assert dc["tokens"].shape == (128,) and dc["pos"].shape == ()
    for arch, shape, kw in (("internvl2-76b", "train_4k",
                             dict(n_clients=4, tau=1)),
                            ("internvl2-76b", "prefill_32k", {}),
                            ("rwkv6-1.6b", "long_500k", {})):
        got = tshapes.input_specs(tconfigs.get_arch(arch),
                                  tshapes.get_shape(shape), **kw)
        want = jshapes.input_specs(jconfigs.get_arch(arch),
                                   jshapes.get_shape(shape), **kw)
        assert got.keys() == want.keys()
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape), (arch, k)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_auto_microbatches_equal_jax(arch):
    shape = tshapes.get_shape("train_4k")
    for clients, replica in ((4, 4), (4, 1), (8, 2)):
        got = tdryrun._auto_microbatches(tconfigs.get_arch(arch), shape,
                                         clients, replica)
        assert got == jdryrun._auto_microbatches(
            jconfigs.get_arch(arch), jshapes.get_shape("train_4k"), clients,
            replica)
        assert (shape.global_batch // clients) % got == 0


# ------------------------------ env -----------------------------------------

def test_profile_env_validates_and_matches_jax_without_xla():
    with pytest.raises(ValueError):
        tenv.profile_env("gpu-turbo")
    with pytest.raises(ValueError):
        tenv.profile_env("host", host_devices=0)
    assert tenv.ENV_PROFILES == jenv.ENV_PROFILES
    assert tenv.TCMALLOC_PATHS == jenv.TCMALLOC_PATHS
    assert tenv.profile_env("none", base={}) == {}
    for base in ({}, {"LD_PRELOAD": "/x.so"}):
        want = jenv.profile_env("host", base=base)
        want.pop("TF_CPP_MIN_LOG_LEVEL")       # no meaning for PyTorch
        assert tenv.profile_env("host", base=base) == want
    before = dict(os.environ)
    tenv.profile_env("host")
    assert dict(os.environ) == before


@pytest.mark.parametrize("profile,devices", [("cpu-mesh", 1), ("host", 2),
                                             ("none", 4)])
def test_mesh_profiles_raise_naming_item_12(profile, devices, monkeypatch):
    """The cpu-mesh profile and --host-devices are accepted: a profile
    re-execs with the host profile's environment, and only cpu-mesh runs
    the launcher as --host-devices gloo ranks (--host-devices means
    nothing under the others, as in the JAX package)."""
    monkeypatch.delenv(tenv._APPLIED_VAR, raising=False)
    execs = []

    def fake_exec(exe, argv, env):
        execs.append(env)
        raise SystemExit(0)

    monkeypatch.setattr(os, "execvpe", fake_exec)
    if profile == "none":
        assert tenv.apply_env_profile(profile, host_devices=devices) is False
        assert execs == []
    else:
        with pytest.raises(SystemExit):
            tenv.apply_env_profile(profile, host_devices=devices)
        assert execs[0][tenv._APPLIED_VAR] == "1"
    assert tenv.profile_env("cpu-mesh", host_devices=devices,
                            base={}) == tenv.profile_env("host", base={})
    assert tenv.host_ranks(profile, devices) == (
        devices if profile == "cpu-mesh" else 1)
    with pytest.raises(ValueError):
        tenv.host_ranks(profile, 0)


def test_find_tcmalloc_prefers_listed_order(tmp_path):
    a, b = tmp_path / "full.so", tmp_path / "minimal.so"
    a.write_bytes(b"")
    b.write_bytes(b"")
    assert tenv.find_tcmalloc((str(a), str(b))) == str(a)
    assert tenv.find_tcmalloc((str(tmp_path / "nope.so"),)) is None
    assert tenv.find_tcmalloc() == jenv.find_tcmalloc()


def test_apply_guard_and_reexec(monkeypatch):
    """The guard makes the exec happen exactly once: with it set a call is
    a no-op; without it execvpe gets the same argv, the profile's delta and
    the guard."""
    monkeypatch.setattr(os, "execvpe", lambda *a: pytest.fail("exec'd"))
    monkeypatch.delenv(tenv._APPLIED_VAR, raising=False)
    assert tenv.apply_env_profile(None) is False
    assert tenv.apply_env_profile("none") is False
    monkeypatch.setenv(tenv._APPLIED_VAR, "1")
    assert tenv.apply_env_profile("host") is False

    monkeypatch.delenv(tenv._APPLIED_VAR)
    captured = {}

    def fake_exec(exe, argv, env):
        captured.update(exe=exe, argv=argv, env=env)
        raise SystemExit(0)

    monkeypatch.setattr(os, "execvpe", fake_exec)
    with pytest.raises(SystemExit):
        tenv.apply_env_profile("host")
    assert captured["exe"] == sys.executable
    assert captured["argv"] == [sys.executable] + sys.argv
    assert captured["env"][tenv._APPLIED_VAR] == "1"
    for k, v in tenv.profile_env("host").items():
        assert captured["env"][k] == v


# ------------------------------ cost_of -------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_cost_of_a_matmul_is_the_analytic_count():
    x, w = _meta(64, 128), _meta(128, 32)

    def f(x, w):
        a = x @ w
        b = torch.relu(a)
        del a
        return (b * 2).sum()

    cost, out = cost_of(f, x, w)
    assert out.device.type == "meta"
    assert cost.flops == 2 * 64 * 128 * 32
    # mm reads x, w and writes a; relu and mul read and write 64 x 32; sum
    # reads 64 x 32 and writes a scalar
    n = 64 * 32 * 4
    assert cost.hbm_bytes == (64 * 128 + 128 * 32) * 4 + n + 2 * n + 2 * n \
        + n + 4
    # a and b alive together; a freed before the product
    assert cost.peak_live_bytes == 2 * n + 4
    assert cost_analysis_dict(cost) == {"flops": cost.flops,
                                        "bytes accessed": cost.hbm_bytes}
    assert cost.by_op["aten.mm"]["calls"] == 1


def _kernel_calls():
    """(name, wrapper call on meta tensors, its cost)."""
    g, z = _meta(3, 5000), _meta(3, 5000)
    sig = _meta(3)
    q = _meta(2, 4, 40, 32, dtype=torch.bfloat16)
    w = _meta(2, 4, 40, 32)
    u = _meta(4, 32)
    x = _meta(2, 64, 4, 16, dtype=torch.bfloat16)
    dt, a = _meta(2, 64, 4), _meta(4)
    bc = _meta(2, 64, 8, dtype=torch.bfloat16)
    cache = _meta(16, 33)
    slots = torch.empty((4,), dtype=torch.int32, device="meta")
    return [
        ("dp_clip_noise", lambda: dp_clip_noise.dp_clip_noise(g, z, 1.0, sig),
         dp_clip_noise.cost(3, 5000)),
        ("quantize_decompress",
         lambda: quantize_decompress.quantize_decompress(g, z, 4),
         quantize_decompress.cost(3, 5000)),
        ("cohort_gather_scatter",
         lambda: cohort_gather_scatter.cohort_gather_scatter(cache, slots),
         cohort_gather_scatter.cost(4, 33, 4, 4)),
        ("flash_attention",
         lambda: flash_attention.flash_attention(q, q, q, window=16),
         flash_attention.cost(2, 4, 40, 32, window=16, itemsize=2)),
        ("rwkv6_scan", lambda: rwkv6_scan.rwkv6_scan(q, q, q, w, u),
         rwkv6_scan.cost(2, 4, 40, 32, itemsize=2)),
        ("mamba2_ssd", lambda: mamba2_ssd.mamba2_ssd(x, dt, a, bc, bc,
                                                     chunk=16),
         mamba2_ssd.cost(2, 64, 4, 16, 8, 16, itemsize=2)),
    ]


@pytest.mark.parametrize("i", range(6), ids=[
    "dp_clip_noise", "quantize_decompress", "cohort_gather_scatter",
    "flash_attention", "rwkv6_scan", "mamba2_ssd"])
def test_each_kernel_cost_is_counted_once_per_call_on_meta(i):
    name, call, (flops, nbytes) = _kernel_calls()[i]
    cost, out = cost_of(lambda: (call(), call()))
    assert cost.kernel_calls(name) == 2
    assert cost.flops == 2 * flops and cost.hbm_bytes == 2 * nbytes
    assert set(cost.by_op) == {f"kernel:{name}"}
    outs = out[0] if isinstance(out[0], tuple) else (out[0],)
    assert all(t.device.type == "meta" for t in outs)
    launches = getattr(sys.modules[f"repro_torch.kernels.{name}"],
                       name).launches
    call()                                   # outside a counter: shapes only
    assert getattr(sys.modules[f"repro_torch.kernels.{name}"],
                   name).launches == launches


def test_meta_outputs_have_the_plain_versions_shapes():
    """A wrapper's meta outputs: the shapes and dtypes its plain version
    returns on the CPU."""
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(0)
    r = torch.randn((1, 2, 20, 16), generator=gen, dtype=torch.bfloat16)
    w = torch.rand((1, 2, 20, 16), generator=gen)
    u = torch.randn((2, 16), generator=gen)
    want = ref.rwkv6_scan_ref(r, r, r, w, u)
    got = rwkv6_scan.rwkv6_scan(*(t.to("meta") for t in (r, r, r, w, u)))
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]
    x = torch.randn((1, 32, 2, 16), generator=gen)
    dt, a = torch.rand((1, 32, 2), generator=gen), -torch.rand(2,
                                                              generator=gen)
    b = torch.randn((1, 32, 8), generator=gen)
    want = ref.mamba2_ssd_ref(x, dt, a, b, b, 16)
    got = mamba2_ssd.mamba2_ssd(*(t.to("meta") for t in (x, dt, a, b, b)),
                                chunk=16)
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]


def test_kernel_cost_replaces_the_plain_versions_ops_on_the_cpu():
    """On CPU tensors the wrapper runs its plain version, yet the counter
    sees the kernel's cost once and none of the plain version's ops."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 24, 16), generator=gen)
    cost, out = cost_of(flash_attention.flash_attention, q, q, q)
    assert cost.kernel_calls("flash_attention") == 1
    assert set(cost.by_op) == {"kernel:flash_attention"}
    assert (cost.flops, cost.hbm_bytes) == flash_attention.cost(
        1, 2, 24, 16, itemsize=4)
    torch.testing.assert_close(out, flash_attention.flash_attention(q, q, q),
                               rtol=0, atol=0)


def test_kernel_costs_are_the_bounds_chip_smoke_uses():
    """Each kernel's cost gives the bound PERF.md's table was built from
    (``chip_smoke.py``'s bound functions)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke as cs

    def bound(flops, nbytes, peak=cs.F32_FLOPS_PER_S):
        return cs._larger_bound(nbytes, flops, peak)

    assert cs._bound_ms(64, 262_144, True) == bound(
        *dp_clip_noise.cost(64, 262_144))
    assert cs._bound_ms(16, 210, False) == bound(
        *dp_clip_noise.cost(16, 210, with_noise=False))
    assert cs._qsgd_bound_ms(4, 4096) == bound(
        *quantize_decompress.cost(4, 4096))
    assert cs._larger_bound(2 * 16 * 42 * 4 + 8 * 16, 0) == bound(
        *cohort_gather_scatter.cost(16, 42, 4, 8))
    bf16 = cs.BF16_FLOPS_PER_S
    assert cs._flash_bound(torch, 2, 8, 2048, 256, 1024, torch.bfloat16) \
        == bound(*flash_attention.cost(2, 8, 2048, 256, 1024, 2), bf16)
    assert cs._rwkv_bound(torch, 2, 32, 512, 64, True, torch.bfloat16) \
        == bound(*rwkv6_scan.cost(2, 32, 512, 64, True, 2), bf16)
    assert cs._ssd_bound(torch, 2, 512, 112, 64, 64, 128, torch.bfloat16) \
        == bound(*mamba2_ssd.cost(2, 512, 112, 64, 64, 128, 2), bf16)


# ------------------------------ dry run -------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-4b", "rwkv6-1.6b", "zamba2-7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_dryrun_run_one_on_a_smoke_variant(arch):
    """Prefill and decode step of a smoke model on meta, one arch per
    mixer (attention, rwkv, ssm, moe), and the train round of the rwkv and
    moe ones: records with JAX's fields, the model kernels counted at
    their launch formulas, dp_clip_noise once per local step, nothing
    allocated."""
    from repro_torch.configs.shapes import InputShape
    cfg = tconfigs.smoke_variant(tconfigs.get_arch(arch))
    kernels = {"gemma3-4b": {"flash_attention"},
               "rwkv6-1.6b": {"rwkv6_scan"},
               "zamba2-7b": {"flash_attention", "mamba2_ssd"},
               "phi3.5-moe-42b-a6.6b": {"flash_attention"}}[arch]
    shapes = (InputShape("mini_train", 16, 4, "train"),
              InputShape("mini_pf", 32, 2, "prefill"),
              InputShape("mini_dec", 32, 2, "decode"))
    for shape in shapes[arch in ("gemma3-4b", "zamba2-7b"):]:
        rec = tdryrun.run_one(arch, shape.name, n_clients=2, tau=2, cfg=cfg,
                              shape=shape)
        assert rec["status"] == "traced" and rec["mesh"] == "1xH100"
        n = tshapes.param_count_estimate(cfg)
        assert rec["n_params"] == n
        assert rec["active_params"] == troof.active_params(cfg, float(n))
        r = rec["roofline"]
        assert r["flops_per_device"] == rec["cost_analysis_raw"]["flops"] > 0
        assert r["hbm_bytes_per_device"] > 0
        assert rec["live_bytes_per_device"] >= rec["memory_analysis"][
            "params_bytes"] + rec["memory_analysis"]["temp_peak_bytes"]
        assert rec["fits_hbm"] and tdryrun.bound_ms(rec) > 0
        if shape.kind == "train":
            assert rec["tokens_per_step"] == 4 * 16 * 2
            assert rec["kernels"] == {"dp_clip_noise": {
                **rec["kernels"]["dp_clip_noise"], "calls": 2}}
            assert rec["memory_analysis"]["optimizer_bytes"] > 0
        elif shape.kind == "prefill":
            assert set(rec["kernels"]) == kernels
            assert rec["tokens_per_step"] == 64
        else:
            assert rec["tokens_per_step"] == 2
            assert rec["memory_analysis"]["caches_bytes"] > 0


def test_dryrun_refuses_what_only_steers_xla(tmp_path):
    """The opts that only steer XLA raise; ``--multi-pod`` (once refused
    naming item 12d) records on the 2x16x16 mesh: a combo the arch does
    not support is written as skipped under its 2x16x16 tag (the per-rank
    records themselves: tests/test_torch_dryrun_per_rank.py)."""
    import json
    for opt in tdryrun.XLA_OPTS:
        with pytest.raises(ValueError, match="XLA"):
            tdryrun.apply_opts(tconfigs.get_arch("gemma3-4b"), (opt,))
    assert tdryrun.main(["--arch", "granite-20b", "--shape", "long_500k",
                         "--multi-pod", "--out-dir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "granite-20b_long_500k_1xH100_2x16x16"
                                  ".json").read_text())
    assert rec["status"] == "skipped"
    skipped = tdryrun.run_one("granite-20b", "long_500k")
    assert skipped["status"] == "skipped" and "skip" in skipped["reason"]


def test_roofline_suite_tables_the_dryrun_records(tmp_path):
    """benchmarks/roofline_torch.py reads the dry run's JSON records: one
    CSV row and one markdown row per record, skipped ones included."""
    import json

    from repro_torch.configs.shapes import InputShape
    root = os.path.dirname(os.path.dirname(__file__))
    sys.path.insert(0, root)
    import benchmarks.roofline_torch as roofline
    cfg = tconfigs.smoke_variant(tconfigs.get_arch("codeqwen1.5-7b"))
    recs = [tdryrun.run_one("codeqwen1.5-7b", "mini", cfg=cfg,
                            shape=InputShape("mini", 32, 2, "prefill")),
            tdryrun.run_one("granite-20b", "long_500k")]
    records = tmp_path / "dryrun"
    records.mkdir()
    for i, rec in enumerate(recs):
        (records / f"{i}.json").write_text(json.dumps(rec))
    out = tmp_path / "roofline.json"
    rows = roofline.main(out_json=str(out), dirname=str(records))
    assert rows[0].startswith("roofline_codeqwen1.5-7b_mini_1xH100,")
    assert float(rows[0].split(",")[1]) == pytest.approx(
        tdryrun.bound_ms(recs[0]) * 1e3, abs=0.05)      # "%.1f" us
    assert rows[1].endswith("status=skipped")
    assert json.loads(out.read_text())["rows"] == rows
    table = roofline.markdown_table(roofline.load_records(str(records)))
    assert table.count("\n") == 3 and "codeqwen1.5-7b" in table
    assert roofline.main(dirname=str(tmp_path / "none"))[0].startswith(
        "roofline_no_dryruns_found")


def test_dryrun_extension_equals_a_full_trace():
    """The dry run traces shallow models and few local steps and extends
    the counts (polynomial in each segment's steps past DIRECT_STEPS,
    linear in tau and the microbatches): on a smoke MoE model at 5 steps,
    tau 2 and 2 microbatches its flops, bytes and kernel calls equal one
    full trace's, and its peak of live bytes is within 1%."""
    from repro_torch.api import FederationSpec, get_engine
    from repro_torch.configs.shapes import InputShape
    from repro_torch.models.transformer import Transformer
    base = tconfigs.smoke_variant(tconfigs.get_arch("phi3.5-moe-42b-a6.6b"))
    cfg = tdryrun._with_steps(base, [5] * len(base.segments))
    model = Transformer(cfg)
    params = model.init(device="meta")
    n = tdryrun.param_count(params)
    opt = tsgd(0.1)
    train = InputShape("t", 8, 4, "train")
    spec = FederationSpec(n_clients=2, tau=2, loss_fn=model.loss_fn,
                          optimizer=opt, engine="vmap", clip_norm=1.0,
                          dp=True, num_microbatches=2,
                          vmap_microbatches=False)
    assert 5 > tdryrun.DIRECT_STEPS
    full = [cost_of(get_engine("vmap")(spec),
                    tdryrun._stack_clients(params, 2),
                    tdryrun._stack_clients(opt.init(params), 2),
                    tshapes.input_specs(cfg, train, 2, 2),
                    torch.empty((2, 2, n), device="meta"),
                    torch.empty((2,), device="meta"))[0]]
    got = [tdryrun.trace_train(cfg, train, 2, 2, microbatches=2)[0]]
    pf, dec = InputShape("p", 32, 2, "prefill"), InputShape("d", 32, 2,
                                                            "decode")
    toks = tshapes.input_specs(cfg, pf)["tokens"]
    full.append(cost_of(model.prefill, params, toks, max_len=32)[0])
    got.append(tdryrun.trace_prefill(cfg, pf)[0])
    full.append(cost_of(model.decode_step, params,
                        model.init_cache(2, 32, device="meta"),
                        tshapes.input_specs(cfg, dec)["tokens"], 31)[0])
    got.append(tdryrun.trace_decode(cfg, dec)[0])
    for g, f in zip(got, full):
        assert g.flops == f.flops and g.hbm_bytes == f.hbm_bytes
        assert {k: v["calls"] for k, v in g.by_op.items()} == {
            k: v["calls"] for k, v in f.by_op.items()}
        assert abs(g.peak_live_bytes / f.peak_live_bytes - 1) <= 0.01
    assert got[0].kernel_calls("dp_clip_noise") == 2 * 2
