"""The serving mesh's decode rules, the model axis' acceptance of KV heads
it does not divide, a rank's share of a split decode cache, and the dry
run's mesh report, against the JAX package (host only, no ranks).

* ``sharding.decode_mesh_rules`` gives the ``batch`` / ``seq`` /
  ``kv_tp`` / ``cache_seq`` entries that JAX's ``lower_decode`` installs
  (``src/repro/launch/dryrun.py:216-228``, captured at its
  ``axis_rules``), over KV heads that divide the model axis or not x
  ``shard_seq`` on or off; the dry run's decode records carry them for
  the production mesh.
* ``param_split_dims`` and ``check_model_axis`` take granite-20b at a
  model axis of 2 and gemma3-4b at 8 (their K/V whole) and still raise
  ``ValueError`` where the axis does not divide the query heads or a
  width; a rank's decode cache on ``meta`` is ``1 / g`` of the whole.
* ``dryrun.mesh_report`` rows equal JAX's for every assigned arch at the
  same budget, client count and device count; ``--mesh-report`` prints
  them and exits 1 when a row does not fit.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib
import io
from types import SimpleNamespace

import pytest

import repro.launch.dryrun as jdryrun
from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.configs import smoke_variant as jax_smoke_variant
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import dryrun
from repro_torch.models import sharding
from repro_torch.models.transformer import Transformer
from repro_torch.utils.tree import tree_flatten

KEYS = ("batch", "seq", "kv_tp", "cache_seq")


class _Captured(Exception):
    pass


def jax_decode_rules(arch, mesh_shape, shape_name, monkeypatch):
    """The rules JAX's ``lower_decode`` installs for ``arch``'s smoke
    variant (its KV heads are the arch's where they fit its 4 query
    heads) on a ``(dd, dm)`` serving mesh, captured where it enters
    ``axis_rules``."""
    dd, dm = mesh_shape
    seen = {}

    @contextlib.contextmanager
    def capture(mesh, rules):
        seen.update(rules)
        raise _Captured
        yield

    monkeypatch.setattr(jdryrun, "make_serving_mesh", lambda mesh:
                        SimpleNamespace(shape={"data": dd, "model": dm}))
    monkeypatch.setattr(jdryrun, "axis_rules", capture)
    cfg = jax_smoke_variant(jax_get_arch(arch))
    with pytest.raises(_Captured):
        jdryrun.lower_decode(cfg, jax_get_shape(shape_name), None)
    return cfg.n_kv_heads, {k: seen[k] for k in KEYS}


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch,mesh_shape", [
    ("gemma3-4b", (2, 2)), ("gemma3-4b", (1, 4)),      # kv 4: divides
    ("gemma3-4b", (2, 8)),                             # does not
    ("granite-20b", (1, 2)), ("granite-20b", (4, 4)),  # MQA
    ("granite-20b", (2, 1))])
def test_decode_rules_are_jax_lower_decode(arch, mesh_shape, shape_name,
                                           monkeypatch):
    kv, want = jax_decode_rules(arch, mesh_shape, shape_name, monkeypatch)
    got = sharding.decode_mesh_rules(kv, mesh_shape,
                                     shard_seq=shape_name == "long_500k")
    assert {k: got[k] for k in KEYS} == want
    # the weights' entries stay the training mesh's placement
    assert {k: got[k] for k in ("fsdp", "tp", "wg")} == {
        "fsdp": "model", "tp": "model", "wg": None}


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_dry_run_records_the_production_decode_rules(shape_name):
    """The decode records' ``serving_rules``: the KV entries as above, and
    the weights' ``fsdp`` / ``wg`` on "data" exactly where the JAX dry run
    splits them there (``_needs_param_sharding``; at the card's memory,
    the default, no arch here; at JAX's 16 GiB, mistral-large-123b)."""
    for arch in ("gemma3-4b", "granite-20b", "mistral-large-123b"):
        cfg = jax_get_arch(arch)          # the full arch's KV heads
        want = sharding.decode_mesh_rules(
            cfg.n_kv_heads, (16, 16), shard_seq=shape_name == "long_500k")
        for mem in (None, jdryrun.HBM_PER_CHIP):
            got = dryrun.serving_rules(get_arch(arch), get_shape(shape_name),
                                       device_mem_bytes=mem
                                       or dryrun.HBM_PER_CARD)
            fsdp = "data" if mem and arch == "mistral-large-123b" else None
            assert got == {"mesh_shape": [16, 16],
                           **{k: want[k] for k in KEYS},
                           "fsdp": fsdp, "wg": fsdp}, (arch, mem)
        if arch == "granite-20b":
            assert got["cache_seq"] == (("data", "model")
                                        if shape_name == "long_500k"
                                        else "model")


@pytest.mark.parametrize("arch,dm", [("granite-20b", 2), ("granite-20b", 16),
                                     ("gemma3-4b", 8),
                                     ("phi3.5-moe-42b-a6.6b", 16)])
def test_model_axis_keeps_undivided_kv_heads_whole(arch, dm):
    model = Transformer(get_arch(arch))
    model.check_model_axis(dm)
    params = model.init(device="meta")
    dims = sharding.param_split_dims(params, dm)
    seg = dims["segments"][0]["0"]["mixer"]
    assert (seg["wq"], seg["wk"], seg["wv"], seg["wo"]) == (2, -1, -1, 1)
    assert sharding.split_sizes(params).keys().isdisjoint(sharding.KV_LEAVES)


@pytest.mark.parametrize("arch,dm", [("gemma3-4b", 3), ("granite-20b", 5),
                                     ("granite-20b", 32)])
def test_model_axis_still_refuses_undivided_query_heads(arch, dm):
    model = Transformer(get_arch(arch))
    with pytest.raises(ValueError, match="can be one of"):
        model.check_model_axis(dm)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.param_split_dims(model.init(device="meta"), dm)


class _Rank:
    """Rank ``coord`` of a ``(dd, dm)`` serving mesh as the model code sees
    it, without a process group: enough to size its caches."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coord):
        self.shape, self._coord = shape, coord

    def get_coordinate(self):
        return list(self._coord)

    @staticmethod
    def get_group(axis):
        return None


def _cache_bytes(caches):
    return sum(x.numel() * x.element_size() for x in tree_flatten(caches)[0])


@pytest.mark.parametrize("arch,mesh_shape,shard_seq,batch,max_len", [
    ("granite-20b", (1, 2), False, 2, 2064),       # MQA: seq on "model"
    ("gemma3-4b", (2, 1), True, 1, 524_288),       # long_500k: on "data"
    ("gemma3-4b", (1, 8), False, 2, 4096)])        # kv 4 on 8: on "model"
def test_a_ranks_decode_cache_is_its_block_on_meta(arch, mesh_shape,
                                                   shard_seq, batch,
                                                   max_len):
    model = Transformer(get_arch(arch))
    whole = _cache_bytes(model.init_cache(batch, max_len, "meta"))
    g = mesh_shape[0] * mesh_shape[1]
    rules = sharding.decode_mesh_rules(model.cfg.n_kv_heads, mesh_shape,
                                       shard_seq)
    placement = sharding.param_split_dims(model.init(device="meta"),
                                          mesh_shape[1], rules)
    with sharding.axis_rules(_Rank(mesh_shape, (0, 0)), rules, placement):
        assert sharding.kv_heads_whole() == (mesh_shape[1] > 1)
        caches = model.init_cache(batch, max_len, "meta")
    assert _cache_bytes(caches) * g == whole
    k = caches[0]["0"]["mixer"]["k"]
    assert k.shape[2] * g == model.init_cache(
        batch, max_len, "meta")[0]["0"]["mixer"]["k"].shape[2]


def test_mesh_report_rows_are_jax(monkeypatch):
    monkeypatch.delenv("REPRO_DEVICE_MEM_BYTES", raising=False)
    budget = 16 * 1024 ** 3
    for n_clients, n_devices in ((8, 8), (4, 16)):
        want = jdryrun.mesh_report(ASSIGNED_ARCHS, n_clients, n_devices,
                                   device_mem_bytes=budget)
        got = dryrun.mesh_report(ASSIGNED_ARCHS, n_clients, n_devices,
                                 device_mem_bytes=budget)
        assert got == want
    assert not all(r["fits"] for r in got)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.print_mesh_report(got)
        jdryrun.print_mesh_report(want)
    text = out.getvalue().splitlines()
    assert text[:len(text) // 2] == text[len(text) // 2:]


def test_mesh_report_cli_exits_1_where_a_row_does_not_fit(tmp_path,
                                                          monkeypatch):
    monkeypatch.delenv("REPRO_DEVICE_MEM_BYTES", raising=False)
    common = ["--mesh-report", "--devices", "8", "--out-dir", str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert dryrun.main(common + ["--device-mem-gb", "16"]) == 1
        assert dryrun.main(common + ["--device-mem-gb", "1024",
                                     "--arch", "granite-20b"]) == 0
    assert "granite-20b" in out.getvalue()
    assert (tmp_path / "mesh_report.json").exists()
