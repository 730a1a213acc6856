"""repro_torch.launch.dryrun against repro.launch.dryrun.

One module-scoped child runs the reference (importing ``repro.launch.dryrun``
sets ``XLA_FLAGS`` for its whole process, so it never runs in a pytest
worker): its ``layer_types`` for the ten archs, and its step builders
compiled on reduced qwen2, granite and grok: one and two unrolled layers of
a 2 x 64 train batch on a (1, 1) mesh, one layer of 8 x 64 on a (2, 4) mesh
of 8 fake devices. The port's ``_measure`` on the same cells is held to
XLA's cost and memory analyses and to the partitioned HLO's collectives:

* flops per device within 10% (products, elementwise ops and reductions;
  measured 98.7-99.2%);
* argument bytes per device equal;
* bytes: the eager port's unfused traffic is 1.2-2.1x XLA's fused "bytes
  accessed" on one device, held to [1, 3]; on the (2, 4) mesh the ideal
  partition (the walk's bytes over 8) leaves out the weights each device
  gathers, 0.51-0.84x, held to [1/3, 3];
* collective bytes 0 on (1, 1), and on (2, 4) a total within 2x of the
  reference's (measured 0.64-0.83x).

The CLI runs in a second child alongside, on a full-size decode cell.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.launch import roofline as rroofline
from repro.launch import sharding as rsharding
from repro.models import model as rmodel
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, cells, get_config, reduce_for_smoke
from repro_torch._tree import leaves
from repro_torch.launch import dryrun, sharding
from repro_torch.launch.specs import input_specs_for
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.train import steps as steps_lib

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-1.5b", "granite-3-8b", "grok-1-314b")
SMALL = ShapeConfig("t_small", "train", 64, 2)
MESHED = ShapeConfig("t_mesh", "train", 64, 8)
CELLS = [(a, "small", k) for a in ARCHS for k in (1, 2)] + [(a, "mesh", 1) for a in ARCHS]

_CHILD = textwrap.dedent(
    """
    import json, sys
    import jax
    jax.devices()  # 8 fake devices, before repro.launch.dryrun sets its 512
    import numpy as np
    from repro.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config, reduce_for_smoke
    from repro.launch import dryrun, roofline
    from repro.launch.mesh import make_mesh, set_mesh

    def fields(cfg):
        out = {}
        for f, v in vars(cfg).items():
            if f in ("dtype", "param_dtype"):
                v = np.dtype(v).name
            out[f] = v
        return out

    res = {"layer_types": {}, "cost": {}}
    for arch in ARCH_IDS:
        res["layer_types"][arch] = [[n, c, fields(mk(1)), fields(mk(2))] for n, mk, c in dryrun.layer_types(arch)]
    SHAPES["t_small"] = ShapeConfig("t_small", "train", 64, 2)
    SHAPES["t_mesh"] = ShapeConfig("t_mesh", "train", 64, 8)
    for arch in %r:
        base = reduce_for_smoke(get_config(arch))
        for name, mshape, ks in (("small", (1, 1), (1, 2)), ("mesh", (2, 4), (1,))):
            mesh = make_mesh(mshape, ("data", "model"))
            for k in ks:
                with set_mesh(mesh):
                    c = dryrun.lower_step(dryrun._unrolled(base, k), "t_" + name, mesh).compile()
                cost = c.cost_analysis()
                res["cost"]["%%s|%%s|%%d" %% (arch, name, k)] = {
                    "flops": float(cost["flops"]),
                    "bytes": float(cost["bytes accessed"]),
                    "arg": int(c.memory_analysis().argument_size_in_bytes),
                    "coll": roofline.collective_bytes(c.as_text()),
                }
    json.dump(res, open(sys.argv[1], "w"))
    print("DRYRUN_REF_OK")
    """
    % (ARCHS,)
)


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The reference child's readings, and the port's CLI run (both started
    together)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", _CHILD, str(tmp / "ref.json")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-1.5b", "--shape", "decode_32k",
         "--mesh", "single", "--out", str(tmp / "cli")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=tmp,
    )
    ref_out, ref_err = ref.communicate(timeout=600)
    cli_out, cli_err = cli.communicate(timeout=600)
    assert ref.returncode == 0 and "DRYRUN_REF_OK" in ref_out, ref_err[-3000:]
    return {
        "ref": json.loads((tmp / "ref.json").read_text()),
        "cli": (cli.returncode, cli_out, cli_err, tmp / "cli"),
    }


def _fields(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for f in ("dtype", "param_dtype"):
        out[f] = str(out[f]).removeprefix("torch.")
    return json.loads(json.dumps(out))


def test_layer_types_match_reference(children):
    ref = children["ref"]["layer_types"]
    assert sorted(ref) == sorted(ARCH_IDS)
    for arch in ARCH_IDS:
        port = [[n, c, _fields(mk(1)), _fields(mk(2))] for n, mk, c in dryrun.layer_types(arch)]
        assert port == ref[arch], arch


def _port_cell(arch, mesh_name, k):
    mesh, shape = ((1, 1), SMALL) if mesh_name == "small" else ((2, 4), MESHED)
    cfg = dryrun._unrolled(reduce_for_smoke(get_config(arch)), k)
    return dryrun._measure(cfg, shape, make_mesh(mesh, ("data", "model"), devices="meta"))


@pytest.mark.parametrize("arch,mesh_name,k", CELLS)
def test_costs_match_reference(children, arch, mesh_name, k):
    ref = children["ref"]["cost"][f"{arch}|{mesh_name}|{k}"]
    port = _port_cell(arch, mesh_name, k)
    assert abs(port["flops"] / ref["flops"] - 1) <= 0.10
    assert port["arg"] == ref["arg"]
    ratio = port["bytes"] / ref["bytes"]
    if mesh_name == "small":
        assert 1.0 <= ratio <= 3.0
        assert port["coll"] == 0 and port["coll_breakdown"] == {} and ref["coll"] == {}
    else:
        assert 1 / 3 <= ratio <= 3.0
        ref_total = sum(ref["coll"].values())
        assert 0.5 <= port["coll"] / ref_total <= 2.0, (port["coll_breakdown"], ref["coll"])


class _FakeMesh:
    def __init__(self, axis_names, shape):
        self.axis_names, self.shape = axis_names, dict(zip(axis_names, shape))


def _ref_arg_bytes(arch, shape_name, mesh) -> int:
    """Σ leaf bytes over shard factor, from the reference's specs and shapes."""
    cfg = rget(arch)
    shape = SHAPES[shape_name]

    def factor(spec):
        n = 1
        for entry in tuple(spec):
            for a in entry if isinstance(entry, tuple) else (entry,):
                if a is not None:
                    n *= mesh.shape[a]
        return n

    def tree_bytes(shapes, specs, itemsize):
        if isinstance(shapes, dict):
            return sum(tree_bytes(shapes[k], specs[k], itemsize) for k in shapes)
        n = itemsize
        for d in shapes:
            n *= d
        return n // factor(specs)

    pshapes, pspecs = rmodel.param_shapes(cfg), rsharding.param_specs(cfg, mesh)
    total = tree_bytes(pshapes, pspecs, np.dtype(cfg.param_dtype).itemsize)
    b, s = shape.global_batch, shape.seq_len
    act = np.dtype(cfg.dtype).itemsize
    if shape.kind == "train":
        total += 3 * tree_bytes(pshapes, pspecs, 4) + 4
        bspecs = rsharding.batch_specs(cfg, mesh, b, s, "train")
        total += (b * s * 4) // factor(bspecs["labels"])
        if cfg.embeds_input:
            total += (b * s * cfg.d_model * act) // factor(bspecs["embeds"])
        else:
            total += (b * s * 4) // factor(bspecs["tokens"])
    elif shape.kind == "prefill":
        ispec = rsharding.batch_specs(cfg, mesh, b, s, "prefill")
        total += (b * s * (cfg.d_model * act if cfg.embeds_input else 4)) // factor(ispec)
    else:
        total += (b * 4) // factor(rsharding.batch_specs(cfg, mesh, b, 1, "decode"))
        cspec = rsharding.cache_spec(cfg, mesh, b, s)
        for name, shp in rmodel.cache_shapes(cfg, b, s).items():
            n = 4 if name == "ssd" else act
            for d in shp:
                n *= d
            total += n // factor(getattr(cspec, name))
        total += 4  # the length
    return total


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_arg_bytes_on_production_meshes(mesh_name):
    multi = mesh_name == "multi"
    axes, shape = (("pod", "data", "model"), (2, 16, 16)) if multi else (("data", "model"), (16, 16))
    fake = _FakeMesh(axes, shape)
    mesh = make_production_mesh(multi_pod=multi)
    for arch, shape_name, _ in cells():
        low = dryrun.lower_step(get_config(arch), shape_name, mesh)
        port = dryrun._bytes_per_dev(low.inputs(), low.specs, mesh)
        assert port == _ref_arg_bytes(arch, shape_name, fake), (arch, shape_name)


def _reduced(arch, **kw):
    return dataclasses.replace(reduce_for_smoke(get_config(arch)), **kw)


PREFILL = ShapeConfig("p_small", "prefill", 64, 2)


@pytest.mark.parametrize(
    "arch,kw",
    [("granite-3-8b", {"num_layers": 3}), ("gemma3-12b", {"num_layers": 6, "global_every": 3}),
     ("zamba2-2.7b", {"num_layers": 6})],
    ids=["dense", "gemma3", "zamba2"],
)
def test_extrapolation_is_exact(monkeypatch, arch, kw):
    """On a forward step the reference's extrapolation gives the port's
    full-depth walk's flops."""
    cfg = _reduced(arch, **kw)
    monkeypatch.setattr(dryrun, "get_config", lambda a: cfg)
    mesh = make_mesh((1, 1), ("data", "model"), devices="meta")
    est = dryrun.cost_extrapolate(arch, PREFILL, mesh)
    full = dryrun._measure(cfg, PREFILL, mesh)
    assert est["total"]["flops"] == full["flops"]
    assert sum(d["count"] for n, d in est["detail"].items() if n != "base") == (
        cfg.num_layers + (cfg.num_layers // cfg.attn_every if cfg.attn_every else 0))


def test_train_walk_exceeds_extrapolation_by_the_stacked_gradients(monkeypatch):
    """A train step's walk counts (L-1)(L-2)·w flops beyond the
    extrapolation: autograd sums L full-size gradients of each stacked
    layer leaf (w parameters per layer)."""
    cfg = _reduced("granite-3-8b", num_layers=4)
    monkeypatch.setattr(dryrun, "get_config", lambda a: cfg)
    mesh = make_mesh((1, 1), ("data", "model"), devices="meta")
    est = dryrun.cost_extrapolate("granite-3-8b", SMALL, mesh)
    full = dryrun._measure(cfg, SMALL, mesh)
    w = sum(t.numel() for t in leaves(input_specs_for(cfg, SMALL)["params"]["layers"])) // cfg.num_layers
    assert full["flops"] - est["total"]["flops"] == (cfg.num_layers - 1) * (cfg.num_layers - 2) * w


@pytest.mark.parametrize("arch,shape_name", [("qwen2-1.5b", "decode_32k"), ("mamba2-2.7b", "long_500k")])
def test_decode_runs_on_meta(arch, shape_name):
    cfg = reduce_for_smoke(get_config(arch))
    low = dryrun.lower_step(cfg, shape_name, make_production_mesh())
    logits, cache = low.step(*low.inputs())
    b = SHAPES[shape_name].global_batch
    assert logits.device.type == "meta" and logits.shape == (b, 1, cfg.padded_vocab)
    assert cache.length == SHAPES[shape_name].seq_len
    rec = dryrun._measure(cfg, shape_name, make_production_mesh())
    assert rec["flops"] > 0 and rec["bytes"] > 0


def test_builders_compute_on_a_meta_mesh():
    cfg = reduce_for_smoke(get_config("granite-3-8b"))
    mesh = make_production_mesh()
    assert sharding.step_device(mesh) == torch.device("meta")
    low = dryrun.lower_step(cfg, SMALL, mesh)
    new = low.step(*low.inputs())
    assert all(t.device.type == "meta" for t in leaves(new))
    step, _ = steps_lib.make_prefill_step(cfg, mesh, batch=2, seq_len=8)
    logits, _ = step(input_specs_for(cfg, SMALL)["params"], torch.zeros(2, 8, dtype=torch.int32, device="meta"))
    assert logits.device.type == "meta"
    with pytest.raises(ValueError, match="meta"):
        sharding.named(mesh, sharding.param_specs(cfg, mesh))
    assert not torch.cuda.is_initialized()


def test_counter_refuses_a_tensor_off_meta():
    with dryrun._Counter() as c:
        x = torch.empty(4, 8, device="meta") * torch.tensor(2.0)  # a host scalar is allowed
        torch.empty((0,), requires_grad=True)  # and an empty host placeholder
        with pytest.raises(RuntimeError, match="left the meta device"):
            torch.ones(3, device="cpu")
    assert c.flops == 32 and x.device.type == "meta"


def test_cli_writes_the_reference_record(children):
    rc, out, err, out_dir = children["cli"]
    assert rc == 0, err[-3000:]
    assert "all 1 dry-run cells passed" in out
    rec = json.loads((out_dir / "qwen2-1.5b__decode_32k__single__full.json").read_text())
    want = {"arch", "shape", "mesh", "chips", "compile_s", "temp_bytes_per_dev", "arg_bytes_per_dev",
            "out_bytes_per_dev", "coll_schedule_scan_artifact", "cost_detail"}
    want |= {f.name for f in dataclasses.fields(rroofline.Roofline)}
    assert set(rec) == want
    assert rec["chips"] == 256 and rec["t_compute"] > 0 and rec["bottleneck"] in ("compute", "memory", "collective")
