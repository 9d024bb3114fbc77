"""chip_smoke.py's bookkeeping, checked on the CPU: the work it divides by
the card's peaks to get each kernel's bound, the ragged cuts it checks the
redesigned kernels on, and the tables that name each kernel's record.
(The script itself needs the card; its contract is checked there.)"""
import importlib.util
import os

import pytest
import torch

from behindthescenes_tpu.ops.pallas.jitter_density import kernel_cost

# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

B, K, H = 96, 64, 64
KW = dict(n_freqs=6, freq_factor=1.5)


def _decode_args(name, dtype, b=B):
    coord = torch.zeros(b, K)
    h_static = torch.zeros(b, H, dtype=dtype)
    rest = (torch.zeros(13, H), torch.zeros(H), torch.zeros(H),
            torch.zeros(1))
    if name == "selfview":
        return (h_static, coord) + rest
    return (coord, h_static) + rest


@pytest.mark.parametrize("name,dtype,weight_bytes", [
    ("selfview", torch.float32, 4 * (15 * H + 1)),
    ("jitter_density", torch.bfloat16, 2 * 15 * H + 4),
])
def test_decode_work_is_the_jax_kernel_cost(name, dtype, weight_bytes):
    """FLOP are the JAX package's `kernel_cost`, each term at the peak of
    its type; bytes are its count (bf16 h_static) or the f32 one, plus the
    small weights read once."""
    nbytes, flops = cs.work(name, _decode_args(name, dtype), KW)
    want_flop, want_bytes = kernel_cost(B, K, H, 6)
    assert sum(flops.values()) == want_flop
    if name == "selfview":
        want_bytes += 2 * B * H          # h_static in f32, not bf16
        assert set(flops) == {cs.F32_FLOP_S}
    else:                                # products, add + relu, code
        assert flops == {cs.BF16_FLOP_S: B * K * (2 * 13 * H + 2 * H),
                         cs.BF16_VEC_FLOP_S: B * K * 2 * H,
                         cs.F32_FLOP_S: B * K * 2 * 13}
    assert nbytes == want_bytes + weight_bytes


def test_shared_z_work_counts_bf16_inputs_at_two_bytes():
    """bf16 inputs: half the bytes of hs, hd and w; the add and the relu
    run at the bf16 peak of the CUDA cores, the projection's products of
    bf16 values (summed in f32) at the bf16 peak of the tensor cores."""
    args32 = (torch.zeros(B, H), torch.zeros(K, H), torch.zeros(H, 1),
              torch.zeros(1))
    args16 = tuple(a.bfloat16() for a in args32[:3]) + args32[3:]
    b32, f32 = cs.work("shared_z", args32, {})
    b16, f16 = cs.work("shared_z_bf16", args16, {})
    assert b32 == 4 * (B * H + K * H + H + 1 + B * K)
    assert b32 - b16 == 2 * (B * H + K * H + H)
    assert f32 == {cs.F32_FLOP_S: 4 * B * K * H}
    assert f16 == {cs.BF16_VEC_FLOP_S: 2 * B * K * H,
                   cs.BF16_FLOP_S: 2 * B * K * H}


@pytest.mark.parametrize("h,k", cs.RAGGED_HK + cs.RAGGED_ANY_HK)
def test_shared_z_ragged_cut(h, k):
    """shared_z's cut: RAGGED_B rays (a partial tile of 32), k samples (a
    partial tile of 16) and the first h hidden units of hs, hd and w;
    RAGGED_HK's widths run the built kernels, RAGGED_ANY_HK's the
    runtime-shape ones of shared_z and jitter_density."""
    from behindthescenes_tpu_torch.ops.kernels.jitter_density import \
        kernel_for as jitter_kernel_for
    from behindthescenes_tpu_torch.ops.kernels.shared_z import \
        kernel_for as shared_z_kernel_for
    assert cs.RAGGED_B % 32 and k % 16
    built = (h, k) in cs.RAGGED_HK
    assert (shared_z_kernel_for(h) == "built") == built
    assert (jitter_kernel_for(h, 6) == "mma") == built
    args = (torch.arange(2 * cs.RAGGED_B * H, dtype=torch.float32)
            .reshape(2 * cs.RAGGED_B, H), torch.randn(K, H),
            torch.randn(H, 1), torch.randn(1))
    hs, hd, w, b = cs.ragged("shared_z", args, h, k)
    assert torch.equal(hs, args[0][:cs.RAGGED_B, :h])
    assert torch.equal(hd, args[1][:k, :h])
    assert torch.equal(w, args[2][:h]) and b is args[3]
    assert all(a.is_contiguous() for a in (hs, hd, w))


@pytest.mark.parametrize("h,k", cs.RAGGED_HK)
@pytest.mark.parametrize("name", ["selfview", "jitter_density"])
def test_ragged_cut_keeps_the_weights(name, h, k):
    """The cut leaves a partial block of rays and a partial tile of 16
    samples, and keeps the first h hidden units of every weight."""
    assert cs.RAGGED_B % 4 and k % 16 and k % 4 == 0
    args = _decode_args(name, torch.float32, b=2 * cs.RAGGED_B)
    args = tuple(a + torch.arange(a.shape[-1]) for a in args)
    cut = cs.ragged(name, args, h, k)
    coord, h_static = (cut[1], cut[0]) if name == "selfview" \
        else (cut[0], cut[1])
    assert tuple(coord.shape) == (cs.RAGGED_B, k)
    assert tuple(h_static.shape) == (cs.RAGGED_B, h)
    assert all(a.is_contiguous() for a in cut)
    for a, b in zip(cut[2:5], args[2:5]):
        assert torch.equal(a, b[..., :h])
        assert (a is b) == (h == H)
    assert cut[5] is args[5]


@pytest.mark.parametrize("n_freqs", cs.RAGGED_OCTAVES)
def test_octave_cut_runs_the_runtime_shape_kernel(n_freqs):
    """The octave cut redraws W_d as 1 + 2 n_freqs rows in W_d's dtype,
    the same rows on every call, leaves every other argument as it is,
    and asks for a count that only the runtime-shape kernel serves."""
    from behindthescenes_tpu_torch.ops.kernels.jitter_density import \
        jitter_density_plain, kernel_for
    h, k = cs.RAGGED_HK[0]
    args = cs.ragged("jitter_density",
                     _decode_args("jitter_density", torch.bfloat16,
                                  b=cs.RAGGED_B), h, k)
    args = args[:2] + (torch.randn(13, H).bfloat16(),) + args[3:]
    cut, kwargs = cs.octave_cut(args, KW, n_freqs)
    again, _ = cs.octave_cut(args, KW, n_freqs)
    assert kwargs == dict(KW, n_freqs=n_freqs) and KW["n_freqs"] == 6
    assert kernel_for(h, n_freqs) == "any"
    assert cut[2].shape == (1 + 2 * n_freqs, h)
    assert cut[2].dtype == torch.bfloat16 and torch.equal(cut[2], again[2])
    assert all(a is b for i, (a, b) in enumerate(zip(cut, args)) if i != 2)
    out = jitter_density_plain(*cut, **kwargs)
    assert out.shape == (cs.RAGGED_B, k) and torch.isfinite(out).all()


def test_every_record_is_named_everywhere():
    """Each serving mode's record has a tolerance, a source, the TPU kernel
    it replaces (a file:line that defines a function) and a ptxas name."""
    records = {rec for *_, rec in cs.MODES}
    assert records == set(cs.TOLERANCE) == set(cs.KERNEL_META) \
        == set(cs.PTXAS_NAME)
    for source, replaces in cs.KERNEL_META.values():
        assert os.path.exists(os.path.join(ROOT, source))
        path, line = replaces.rsplit(":", 1)
        with open(os.path.join(ROOT, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith("def ")


# -- phases 7-9 rehearsed on the CPU at the small training shape ----------
class _HostClock:
    """Stands in for chip_smoke's CUDA-event clock in the rehearsal."""

    def __call__(self):
        import time
        return time.perf_counter()

    @staticmethod
    def ms(a, b):
        return (b - a) * 1e3

    @staticmethod
    def sync():
        pass


@pytest.fixture(scope="module")
def small_training(tmp_path_factory):
    """exp_synthetic (ResNet-18 at 48x64, 2 items, 256 rays x 24 samples)
    from the port's initialiser, written as a checkpoint, with its batch
    and numpy draws."""
    from behindthescenes_tpu_torch import train as train_cli
    from behindthescenes_tpu_torch.training.trainer import BTSTrainer
    from behindthescenes_tpu_torch.weights import save_params_npz
    conf = train_cli.config("exp_synthetic", f32=True)
    trainer = BTSTrainer(conf, device="cpu")
    trainer.init_state()
    path = str(tmp_path_factory.mktemp("weights") / "init.npz")
    save_params_npz(path, trainer.net.state_dict())
    batch = cs.train_batch(conf)
    return conf, path, batch, cs.numpy_draws(conf, batch, cs.TRAIN_SEED)


def test_numpy_draws_cover_the_patch_ranges(small_training):
    conf, _, batch, draws = small_training
    n, v, h, w, _ = batch["imgs"].shape
    assert (n, v, h, w) == (2, 4, 48, 64)
    pc = conf["model_conf"]["ray_batch_size"] // 16
    for t, hi in ((draws.rays.views, 2), (draws.rays.ys, h - 4),
                  (draws.rays.xs, w - 4)):
        assert t.shape == (n, pc) and 0 <= t.min() and t.max() < hi
    assert draws.z_jitter.shape == (n, 256, 24)
    again = cs.numpy_draws(conf, batch, cs.TRAIN_SEED)
    assert torch.equal(again.z_jitter, draws.z_jitter)


def test_train_parity_rehearsed(small_training):
    """Phase 7 with the host on both sides: its f32 step against its
    float64 step within the phase's bounds, no decode kernel counted."""
    conf, path, batch, draws = small_training
    res = cs.train_parity(conf, path, batch, draws, "cpu")
    assert 0 < res["loss_rel"] <= cs.LOSS_RTOL
    assert 0 < res["grad_norm_rel_max"] <= cs.GRAD_NORM_RTOL
    assert res["tensors"] > 50 and not any(res["launches"].values())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_train_steps_rehearsed(small_training, bf16):
    """Phase 8 for 6 steps: a falling loss, every stage timed."""
    conf, path, batch, draws = small_training
    res = cs.train_steps(conf, path, batch, draws, "cpu", bf16, _HostClock(),
                         steps=6, timed_from=2)
    assert len(res["losses"]) == 6 and res["losses"][-1] < res["losses"][0]
    assert set(res["median_ms"]) == set(cs.STAGES) | {"step"}
    assert abs(sum(res["median_ms"][k] for k in cs.STAGES)
               - res["median_ms"]["step"]) < 0.5 * res["median_ms"]["step"]


def test_general_depth_rehearsed(monkeypatch):
    """Phase 9 on two gate scenes at 48x64 with the flagship checkpoint:
    the per-scene bounds against the self-view metrics hold, and a scene
    outside them fails the phase. The checkpoint was trained at 192x640,
    so at 48x64 its depth is far from the gate (abs_rel 0.67): the
    rehearsal moves the gate's bounds out of the way, as the card's run
    does not."""
    monkeypatch.setattr(cs, "ABS_REL_MAX", 1.0)
    monkeypatch.setattr(cs, "A1_MIN", 0.0)
    from behindthescenes_tpu_torch import eval_depth
    from behindthescenes_tpu_torch.datasets.synthetic import (
        collate, make_test_dataset)
    net = eval_depth.load_model(os.path.join(ROOT, cs.WEIGHTS),
                                device="cpu")
    ds = make_test_dataset(image_size=(48, 64))
    batches = [collate([ds[i]]) for i in range(2)]
    _, selfview = eval_depth.evaluate(net, batches)
    gen = torch.Generator()
    gen.manual_seed(0)
    res = cs.general_depth(net, batches, selfview, gen)
    assert len(res["per_scene"]) == 2
    with pytest.raises(AssertionError):
        worse = [dict(m, abs_rel=m["abs_rel"] + 0.1) for m in selfview]
        cs.general_depth(net, batches, worse, gen)


# -- phases 10-13 rehearsed on the CPU at 24x32 -----------------------------
# 4 scenes at 24x32, in f32: bf16 convolutions are slow on a loaded CPU.
CUT = ("data.image_size=[24, 32]", "data.length=8", "bf16=false")
# The rows of CONFIG_RUNS before the converged exp_synthetic checkpoint's;
# tests/test_torch_chip_smoke_fast.py rehearses those at their own size.
FIRST_RUNS = tuple(r for r in cs.CONFIG_RUNS
                   if r[2] != cs.STEP8400_WEIGHTS)


def test_config_phases_rehearsed(monkeypatch, capsys):
    """Phases 10-13 as main() runs them, at CUT: every config
    of CONFIG_RUNS but the step8400 rows with its checkpoint through the
    task runner, per-scene metrics recorded and printed, the NVS frames
    split into encode and render, shared_z counted on the flagship's
    depth (a wrapper call counts as a launch here), then the fine pass's
    profiles. The JAX means and the fine pass's margin are those of the
    configs' own sizes, so the rehearsal moves those bounds out of the
    way; reuse against re-query keeps its bound."""
    _count_calls(monkeypatch, "shared_z")
    monkeypatch.setattr(cs, "CONFIG_RUNS", FIRST_RUNS)
    monkeypatch.setattr(cs, "JAX_GAP", dict.fromkeys(cs.JAX_GAP, 1e9))
    monkeypatch.setattr(cs, "NVS_FLOORS", {})
    monkeypatch.setattr(cs, "FINE_MARGIN_MIN", -1e9)
    monkeypatch.chdir(ROOT)
    configs, fine, launches = cs.config_phases(
        "cpu", "host", _HostClock, overrides=CUT,
        thin_overrides=("data.image_size=[24, 32]", *cs.THIN_OVERRIDES),
        frames=1)
    assert [c["config"] for c in configs] == [c[1] for c in FIRST_RUNS]
    assert {c["config"] for c in configs} >= {
        "eval_synthetic_flagship_nvs", "eval_synthetic_re10k_nvs",
        "exp_synthetic_re10k", "eval_synthetic_flagship"}
    assert launches == {}
    for res, (_, name, _, jax_means) in zip(configs, FIRST_RUNS):
        assert len(res["per_scene"]) == 4
        assert set(jax_means) <= set(res["means"])
        assert ("frame_ms" in res) == name.endswith("_nvs")
        assert (res["launches"]["shared_z"] > 0) == \
            (name == "eval_synthetic_flagship")
    assert set(fine["psnr"]) == set(cs.FINE_PROFILES)
    assert fine["reuse_gap"] < cs.REUSE_GAP_MAX
    out = capsys.readouterr().out
    assert out.count("NVS frame (host)") == 2
    assert "8 + 8 fine beats 16 flat" in out


def test_config_phase_bounds_fail_the_run(monkeypatch):
    """A mean outside its bound of JAX's and a missed fine-pass margin each
    fail their phase."""
    monkeypatch.setattr(cs, "JAX_GAP", dict.fromkeys(cs.JAX_GAP, 0.0))
    _, name, ckpt, jax_means = cs.CONFIG_RUNS[2]
    with pytest.raises(AssertionError, match="vs JAX"):
        cs.config_phase(name, os.path.join(ROOT, ckpt), jax_means, "cpu",
                        _HostClock(), overrides=CUT)
    monkeypatch.setattr(cs, "THIN_WEIGHTS",
                        os.path.join(ROOT, cs.THIN_WEIGHTS))
    monkeypatch.setattr(cs, "FINE_MARGIN_MIN", 1e9)
    with pytest.raises(AssertionError, match="beats 16 flat"):
        cs.fine_value("cpu", ("data.image_size=[24, 32]",
                              *cs.THIN_OVERRIDES))


# -- phases 14-15 rehearsed on the CPU at a cut size -----------------------
# The gate drive cut to 6 frames at 1/8 of the reference resolution, its raw
# frames loaded at 32x96; one keyframe per run.
CUT_FRAMES = 6
CUT_HW = (32, 96)
CUT_RUNS = tuple((phase, name, split, (2,), overrides, record)
                 for phase, name, split, _, overrides, record in cs.OCC_RUNS)
CUT_EXTRA = (f"data.image_size=[{CUT_HW[0]}, {CUT_HW[1]}]",
             "data.is_preprocessed=false")


def _count_calls(monkeypatch, name):
    """The kernel wrapper `name`, where models/mlp.py and the kernel table
    call it, counting its calls as launches (on the CPU the wrapper runs
    its plain version and counts nothing)."""
    import functools
    from behindthescenes_tpu_torch import tracing
    from behindthescenes_tpu_torch.models import mlp
    from behindthescenes_tpu_torch.ops import kernels
    fn = kernels.KERNELS[name]

    @functools.wraps(fn)
    def counted(*args, **kwargs):
        tracing.count("launches." + name)
        return fn(*args, **kwargs)
    monkeypatch.setitem(kernels.KERNELS, name, counted)
    monkeypatch.setattr(mlp, fn.__name__, counted)


@pytest.fixture(scope="module")
def gate_tree_cut(tmp_path_factory):
    from behindthescenes_tpu_torch.datasets.gen_synthetic_kitti_360 import \
        make_gate_tree
    tree = str(make_gate_tree(tmp_path_factory.mktemp("gate") / "tree",
                              frames=CUT_FRAMES, scale=0.125,
                              keyframes=(2,)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "OCC_RUNS", CUT_RUNS)
        cs.write_occupancy_splits(tree, CUT_FRAMES)
    return tree


def _cut(monkeypatch):
    """Phases 14-15 at the cut: one keyframe per run, its rays at CUT_HW,
    launches counted; the JAX means and the gate floors are those of the
    full size, so they move out of the way."""
    monkeypatch.setattr(cs, "OCC_RUNS", CUT_RUNS)
    monkeypatch.setattr(cs, "OCC_RAYS", {
        "jitter_density_lidar": CUT_HW[0] * CUT_HW[1],
        "selfview_lidar": CUT_HW[0] * CUT_HW[1],
        "jitter_density_bbox": CUT_HW[0] // 2 * CUT_HW[1] // 2})
    for name in ("jitter_density", "selfview", "shared_z"):
        _count_calls(monkeypatch, name)
    monkeypatch.chdir(ROOT)


def test_occupancy_phases_rehearsed(gate_tree_cut, monkeypatch, capsys):
    """Phases 14-15 as main() runs them: each run through the task runner
    with the k360 checkpoint, its kernel launched once per keyframe on
    its rays and held against its plain version, the means printed beside
    JAX's, and each keyframe's stages split."""
    _cut(monkeypatch)
    monkeypatch.setattr(cs, "OCC_GAP", dict.fromkeys(cs.OCC_GAP, 1e9))
    monkeypatch.setattr(cs, "OCC_FLOORS", {})
    out = cs.occupancy_phases(gate_tree_cut, "cpu", "host", _HostClock,
                              extra=CUT_EXTRA)
    assert [res["record"] for res, _ in out] == \
        ["jitter_density_lidar", "selfview_lidar", "jitter_density_bbox"]
    for res, (kernel, args, kwargs) in out:
        assert kernel == cs.OCC_RECORDS[res["record"]]
        assert res["launches"][kernel] == 1
        assert sum(res["launches"].values()) == 1
        # the plain version against itself (selfview's in float64)
        assert len(res["max_abs_err"]) == 1
        assert res["max_abs_err"][0] <= cs.TOLERANCE[kernel][0]
        assert set(cs.OCC_METRICS) <= set(res["means"])
        assert len(res["stage_ms"]) == 1
        assert set(res["stage_ms"][0]) == {*cs.OCC_STAGES, "item"}
        nbytes, flops = cs.work(kernel, args, kwargs)
        assert nbytes > 0 and sum(flops.values()) > 0
        if res["record"] in cs.OCC_JAX_MEANS:
            assert set(cs.OCC_JAX_MEANS[res["record"]]) <= \
                {k[4:] for k in res if k.startswith("gap_")}
    printed = capsys.readouterr().out
    assert printed.count("keyframe 2 (host)") == 3
    assert "host ground truth" in printed


def test_occupancy_bounds_fail_the_run(gate_tree_cut, monkeypatch):
    """A mean outside its bound of JAX's fails the phase, and so does a
    launch count other than one per keyframe."""
    _cut(monkeypatch)
    monkeypatch.setattr(cs, "OCC_GAP", dict.fromkeys(cs.OCC_GAP, 0.0))
    monkeypatch.setattr(cs, "OCC_FLOORS", {})
    phase, name, split, keyframes, overrides, record = CUT_RUNS[2]
    with pytest.raises(AssertionError, match="vs JAX"):
        cs.occupancy_phase(gate_tree_cut, name, split, keyframes, overrides,
                           record, "cpu", _HostClock(), CUT_EXTRA)
    with pytest.raises(AssertionError, match="kernel launches"):
        cs.occupancy_phase(gate_tree_cut, name, split, (2, 5), overrides,
                           record, "cpu", _HostClock(), CUT_EXTRA)


def test_occupancy_runs_name_their_records():
    """Every occupancy record maps to a kernel with a tolerance, a source,
    the TPU kernel it replaces and a ptxas name; the runs' JAX means and
    floors use the gate's keyframes and the bounds the gate test sets."""
    from behindthescenes_tpu_torch.datasets import \
        gen_synthetic_kitti_360 as gen
    for *_, record in cs.OCC_RUNS:
        base = cs.OCC_RECORDS[record]
        assert base in cs.TOLERANCE and base in cs.KERNEL_META
        assert base in cs.PTXAS_NAME
    lidar, lidar32, bbox = cs.OCC_RUNS
    assert lidar[3] == gen.GATE_KEYFRAMES and lidar[2] == "splits"
    assert lidar32[3] == bbox[3][:1] == gen.GATE_KEYFRAMES[:1]
    assert bbox[3] == gen.GATE_KEYFRAMES[:2]
    assert cs.OCC_FLOORS == {
        "jitter_density_lidar": {"o_acc": 0.85, "ie_prec": 0.55,
                                 "ie_rec": 0.38},
        "jitter_density_bbox": {"o_acc": 0.82, "ie_rec": 0.25}}
    assert cs.OCC_RAYS["jitter_density_bbox"] == 30720
