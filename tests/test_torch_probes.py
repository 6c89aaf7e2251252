"""The measurement probes' plain versions against the reference's TPU probes, on CPU.

Kernels G, S, V and M (cvsteer_tpu_torch.ops.cuda_probes) take their plain
PyTorch versions for CPU tensors; these tests hold each plain version to the
reference's probe script in scripts/ on the same numpy inputs, at a small
size. The scripts are loaded by path and nothing in them changes. Where a
script's kernel runs with ``interpret=pf._interpret()``
(profile_v2_stages.build, profile_frontend.make_variant,
profile_variants.build) it runs here in interpret mode, as
tests/test_pallas_frontend.py runs the production kernels; where it does not
(probe_r3_variants, probe_dma_gather) the plain version is held to what the
script compared with: _g2_maps_reference_xla, and jnp's gather. The kernels
themselves run against these plain versions on the card in
tests/test_torch_cuda.py. Also: utils/profiling.py without a card, and the
probes' entry points.

The scripts' anti-dead-code outputs of the "dma" and "row" stages sit where
their TPU band layout put them: a band's first rows (8-row aligned starts in
profile_v2_stages, an r-row top pad in the others) and an r-column left pad;
the tests read the port's outputs at those rows and columns.
"""

import contextlib
import importlib.util
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cvsteer_tpu.filters.g2 import g2_bank
from cvsteer_tpu.ops import pallas_frontend as pf
from cvsteer_tpu_torch.ops import cuda_probes as cp
from cvsteer_tpu_torch.ops.sepconv import reflect_indices
from cvsteer_tpu_torch.utils import profiling

torch.set_num_threads(2)

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"
R = 4
B, H, W, TILE = 1, 96, 128, 32  # three tiles: first, interior, last


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_probe_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {n: _script(n) for n in ("profile_v2_stages", "profile_frontend", "profile_variants",
                                    "probe_r3_variants", "probe_dma_gather")}


@pytest.fixture(scope="module")
def taps():
    bank = g2_bank()
    return np.asarray(bank.xtaps, np.float32), np.asarray(bank.ytaps, np.float32)


def _image(integers=False, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, H, W)) if integers else rng.uniform(0, 255, (B, H, W))
    return img.astype(np.float32)


def _pad(img, rows: bool):
    """The scripts' padded input: REFLECT_101 by r (columns, and rows when
    ``rows``), then zeros to a 128-multiple width."""
    wp = pf._round_up(W + 2 * R, 128)
    rr = (R, R) if rows else (0, 0)
    p = np.pad(img, ((0, 0), rr, (R, R)), mode="reflect")
    return jnp.asarray(np.pad(p, ((0, 0), (0, 0), (0, wp - W - 2 * R))))


def _run(chain):
    """The pallas_call wrapper ``run`` that a script's jitted ``chain``
    closes over (its chain only returns a scalar)."""
    return inspect.getclosurevars(chain.__wrapped__).nonlocals["run"]


def _np(maps):
    return [np.asarray(m, np.float32) for m in maps]


def _rel_scale(got, want):
    """max |got - want| over max |want|, per map."""
    return [float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want)]


def _rel_mean(got, want):
    """max |got - want| over mean |want|, per map (the reference tests' map measure)."""
    return [float(np.abs(g - w).max() / (np.abs(w).mean() + 1e-6)) for g, w in zip(got, want)]


def _report(record_property, what, figures):
    text = " / ".join(f"{x:.2e}" for x in figures)
    print(f"\nparity {what}: {text}")
    record_property(what, text)


def _reflect(n, shift):
    """REFLECT_101 source of every index i - shift, i in [0, n)."""
    return reflect_indices(-shift, n - shift, n).numpy()


def _v2_rows():
    """Image row of each output row of profile_v2_stages' dma and row stages:
    band row j of tile t starts at the tile's 8-aligned band start."""
    n_tiles = H // TILE
    starts = [0] + [t * TILE - 8 for t in range(1, n_tiles - 1)] + [H - TILE - 16]
    return np.array([starts[y // TILE] + y % TILE for y in range(H)])


def _plain(fn, *args, **kw):
    return _np(fn(*args, **kw))


# ---------------------------------------------------------------------------
# Kernel G
# ---------------------------------------------------------------------------


def _bits(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("lanes", [16, 256, 7])
def test_torch_probe_gather_rows_plain_matches_jnp(lanes):
    """Bit for bit against the script's XLA gather ``tbl[idx]`` (bf16), with
    indices at the table's last row and past it (both clamp there)."""
    rng = np.random.default_rng(1)
    n = 300
    tbl = rng.standard_normal((n, lanes)).astype(np.float32)
    idx = np.concatenate([rng.integers(0, n, 200), [0, n - 1, n, n + 7]]).astype(np.int32)
    want = jnp.asarray(tbl).astype(jnp.bfloat16)[jnp.asarray(idx)]
    got = cp.gather_rows(torch.from_numpy(tbl).to(torch.bfloat16), torch.from_numpy(idx))
    assert got.shape == (idx.size, lanes)
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), _bits(want))


def test_torch_probe_gather_patches_plain_matches_dynamic_slice():
    """Bit for bit against lax.dynamic_slice, the window the script's DMA
    copies; starts at and past the image's bottom and right edges clamp so
    the window fits."""
    rng = np.random.default_rng(2)
    h, w, ph, pw = 40, 8 * 24, 16, 64
    img = rng.standard_normal((h, w)).astype(np.float32)
    ys = np.concatenate([rng.integers(0, h - ph, 30), [0, h - ph, h - 3, h + 5]]).astype(np.int32)
    xs = np.concatenate([rng.integers(0, 16, 30) * 8, [0, w - pw, w - 8, w + 40]]).astype(np.int32)
    jimg = jnp.asarray(img).astype(jnp.bfloat16)
    want = jax.vmap(lambda y, x: lax.dynamic_slice(jimg, (y, x), (ph, pw)))(jnp.asarray(ys), jnp.asarray(xs))
    got = cp.gather_patches(torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(ys),
                            torch.from_numpy(xs), ph, pw)
    assert got.shape == (ys.size, ph, pw)
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), _bits(want))


# ---------------------------------------------------------------------------
# Kernel S
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def v2_outputs(scripts):
    """Every stage of profile_v2_stages.build in interpret mode (module
    globals B, H, W, TILE set small)."""
    mod = scripts["profile_v2_stages"]
    saved = (mod.B, mod.H, mod.W, mod.TILE)
    mod.B, mod.H, mod.W, mod.TILE = B, H, W, TILE
    try:
        img = _image()
        padded = _pad(img, rows=False)
        return img, {stage: _np(_run(mod.build(stage)[1])(padded))
                     for stage in ("dma", "row", "col", "coeff", "full")}
    finally:
        mod.B, mod.H, mod.W, mod.TILE = saved


def test_torch_probe_stages_v2_load_row_match_script(v2_outputs, taps, record_property):
    """load: (x, 2x, 3x) exactly, at the script's band rows and its r-column
    shift. row: the script's x-tap dedup runs each filter's row pass with its
    representative's taps (the scale goes into its column matrices), so the
    plain version gets those taps; its row pass folds mirrored taps, so each
    fp32 row value may differ by rounding and its bf16 hi part by one bf16
    ulp: the hi and lo sums are held to 2^-8 of the summed |row| values,
    their sum to 1e-4 of its scale (hi + lo holds a value to ~2^-17 of
    itself, so two row values one fp32 rounding apart can split into parts
    that far apart)."""
    img, out = v2_outputs
    xt, yt = taps
    rows, cols = _v2_rows(), _reflect(W, R)
    load = _plain(cp.maps_stage, torch.from_numpy(img), xt, yt, "load", "v2")
    for got, want in zip(load, out["dma"]):
        assert np.array_equal(got[:, rows][:, :, cols], want)
    reps, slot_rep, _ = pf._dedup_xtaps(xt)
    rep_taps = xt[[reps[s] for s in slot_rep]]
    got = [g[:, rows] for g in _plain(cp.maps_stage, torch.from_numpy(img), rep_taps, yt, "row", "v2")]
    row_abs = cp.row_pass_plain(torch.from_numpy(img), rep_taps).abs().sum(-3).numpy()[:, rows]
    for g, w in zip(got[:2], out["row"][:2]):
        assert np.all(np.abs(g - w) <= 2.0**-8 * row_abs + 1e-3)
    figures = _rel_scale(got, out["row"])
    _report(record_property, "S v2 row vs profile_v2_stages (rel to scale)", figures)
    assert figures[2] <= 1e-4


@pytest.mark.parametrize("stage,bar", [("col", 1e-4), ("coeff", 1e-4), ("full", 5e-3)])
def test_torch_probe_stages_v2_match_script(v2_outputs, taps, stage, bar, record_property):
    """col / coeff against the script's bf16x3 column pass (the TPU's: it drops
    the lo x lo products, ~2^-16 of each): 1e-4 of scale. full: the maps,
    max/mean <= 5e-3, the reference's bar for its bf16x3 kernel against fp32
    (tests/test_pallas_frontend.py); the steering is ill-conditioned at
    near-isotropic pixels."""
    img, out = v2_outputs
    xt, yt = taps
    got = _plain(cp.maps_stage, torch.from_numpy(img), xt, yt, stage, "v2")
    figures = (_rel_mean if stage == "full" else _rel_scale)(got, out[stage])
    _report(record_property, f"S v2 {stage} vs profile_v2_stages", figures)
    assert max(figures) <= bar


@pytest.fixture(scope="module")
def frontend_outputs(scripts):
    mod = scripts["profile_frontend"]
    img = _image()
    padded = _pad(img, rows=True)
    out = {}
    for stage in ("dma", "row", "col", "coeff", "full"):
        _, chain = mod.make_variant(stage, lax.Precision.HIGHEST, B, H, W, tile_h=TILE)
        out[stage] = _np(_run(chain)(padded))
    _, chain = mod.make_variant("col", lax.Precision.DEFAULT, B, H, W, tile_h=TILE)
    out["col_default"] = _np(_run(chain)(padded))
    return img, out


@pytest.mark.parametrize("stage,bar", [("load", 0.0), ("row", 1e-5), ("col", 1e-5), ("coeff", 1e-5),
                                       ("full", 1e-3)])
def test_torch_probe_stages_frontend_match_script(frontend_outputs, taps, stage, bar,
                                                  record_property):
    """profile_frontend.make_variant at HIGHEST, which is fp32 on the CPU:
    load exactly (at the script's r-column shift), row (filters 0-2, at the
    script's r-row band shift) and col and coeff to 1e-5 of scale (sums in
    another order: the script folds mirrored taps and runs the column pass
    as a matrix product); full, the sqrt / cos / sin maps, to max/mean 1e-3
    (near-isotropic pixels amplify the sums' rounding)."""
    img, out = frontend_outputs
    xt, yt = taps
    got = _plain(cp.maps_stage, torch.from_numpy(img), xt, yt, stage, "frontend")
    want = out["dma" if stage == "load" else stage]
    if stage == "load":
        got = [g[:, :, _reflect(W, R)] for g in got]
    if stage == "row":
        got = [g[:, _reflect(H, R)] for g in got]
    figures = (_rel_mean if stage == "full" else _rel_scale)(got, want)
    _report(record_property, f"S frontend {stage} vs profile_frontend", figures)
    assert max(figures) <= bar


# ---------------------------------------------------------------------------
# Kernel V
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tail,bar", [("base", 5e-3), ("sd", 5e-3), ("tail16", 0.2), ("sd_tail16", 0.2)])
def test_torch_probe_variants_match_r3_reference(taps, tail, bar, record_property):
    """probe_r3_variants' kernels take no interpret flag, so the plain
    variants are held to what the script measured them against,
    _g2_maps_reference_xla, on its u8-valued input: max/mean <= 5e-3 (the
    reference's bar for its kernels against fp32) for the fp32 tails;
    tail16 rounds its steering chains to bf16 (8 bits, ~2^-9 an operation
    over chains of ~8), max/mean <= 0.2, and it must stay further from the
    reference than the fp32 tails."""
    xt, yt = taps
    img = _image(integers=True)
    want = _np(pf._g2_maps_reference_xla(jnp.asarray(img), xt, yt))
    got = _plain(cp.maps_variant, torch.from_numpy(img), xt, yt, tail)
    figures = _rel_mean(got, want)
    _report(record_property, f"V {tail} vs _g2_maps_reference_xla (max/mean)", figures)
    assert max(figures) <= bar
    if "tail16" in tail:
        fp32 = _rel_mean(_plain(cp.maps_variant, torch.from_numpy(img), xt, yt, "base"), want)
        assert max(figures) > max(fp32)


@pytest.mark.parametrize("kind,tail", [("baseline", "sqrt"), ("factored", "factored")])
def test_torch_probe_variants_match_profile_variants(scripts, taps, kind, tail, record_property):
    """profile_variants.build's baseline and factored kernels in interpret
    mode (HIGHEST: fp32 on the CPU): the same algebra in another sum order,
    max/mean <= 1e-3."""
    xt, yt = taps
    img = _image()
    _, _, once = scripts["profile_variants"].build(kind, lax.Precision.HIGHEST, B, H, W, TILE)
    want = _np(once(_pad(img, rows=True)))
    got = _plain(cp.maps_variant, torch.from_numpy(img), xt, yt, tail)
    figures = _rel_mean(got, want)
    _report(record_property, f"V {tail} vs profile_variants {kind} (max/mean)", figures)
    assert max(figures) <= 1e-3


def test_torch_probe_variants_carry_and_tile_are_the_same_function(taps):
    """The carry and the tile height change how kernel V gets there, not
    what: on the CPU every case of a tail is one plain version; the wrapper
    refuses the cases it has no kernel for."""
    xt, yt = taps
    img = torch.from_numpy(_image()[:, :40, :56])
    want = cp.maps_variant(img, xt, yt, "sd_tail16")
    for tile in (32, 64, 96, 128):
        got = cp.maps_variant(img, xt, yt, "sd_tail16", carry=True, tile_h=tile)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        cp.maps_variant(img, xt, yt, "tail16", carry=True)
    with pytest.raises(ValueError):
        cp.maps_variant(img, xt, yt, "sqrt", tile_h=32)
    with pytest.raises(ValueError):  # the G2/H2 bank at width 4 only
        cp.maps_variant(img, np.zeros((7, 13)), np.zeros((7, 13)), "base")


# ---------------------------------------------------------------------------
# Kernel M
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def presplit_outputs(scripts):
    mod = scripts["profile_variants"]
    img = _image()
    padded = _pad(img, rows=True)
    out = {}
    for stage in ("row", "col", "coeff", "full"):
        kind = "presplit" if stage == "full" else f"presplit:{stage}"
        out[stage] = _np(mod.build(kind, lax.Precision.HIGHEST, B, H, W, TILE)[2](padded))
    return img, out


@pytest.mark.parametrize("stage,bar", [("row", 1e-4), ("col", 1e-4), ("coeff", 1e-4), ("full", 1e-3)])
def test_torch_probe_mma_presplit_matches_script(presplit_outputs, taps, stage, bar, record_property):
    """profile_variants' _kernel_presplit in interpret mode: the same bf16
    hi/lo split of the row passes and of the banded column matrix and the
    same three products, summed in fp32 in another order. Its row pass folds
    mirrored taps, so a row value may differ by one fp32 rounding, and its
    hi + lo split (which holds a value to ~2^-17 of itself) by ~2^-17: row
    (at the script's r-row band shift; the hi sum within 2^-8 of the summed
    |row|), col and coeff to 1e-4 of scale; full max/mean 1e-3."""
    img, out = presplit_outputs
    xt, yt = taps
    got = _plain(cp.maps_mma, torch.from_numpy(img), xt, yt, stage, "fp32", "bf16x3")
    if stage == "row":
        got = [g[:, _reflect(H, R)] for g in got]
        row_abs = cp.row_pass_plain(torch.from_numpy(img), xt).abs().sum(-3).numpy()[:, _reflect(H, R)]
        assert np.all(np.abs(got[0] - out["row"][0]) <= 2.0**-8 * row_abs + 1e-3)
        figures = _rel_scale(got[2:], out["row"][2:])
    else:
        figures = (_rel_mean if stage == "full" else _rel_scale)(got, out[stage])
    _report(record_property, f"M presplit {stage} vs profile_variants", figures)
    assert max(figures) <= bar


def test_torch_probe_mma_bf16x1_within_bf16_rounding(frontend_outputs, presplit_outputs, taps,
                                                     record_property):
    """bf16x1 (the TPU's Precision.DEFAULT column pass) rounds the column
    matrix and the rows to bf16 once: each product is within 2^-8 (x 1.01)
    of the exact one, so each basis value is within that much of
    sum |C| |rows|. Held to it against profile_frontend's DEFAULT variant
    (g2a - g2b; the CPU runs DEFAULT in fp32) and against the presplit
    column stage (all three outputs), and farther from them than bf16x3."""
    img, front = frontend_outputs
    _, presplit = presplit_outputs
    xt, yt = taps
    got = _plain(cp.maps_mma, torch.from_numpy(img), xt, yt, "col", "fp32", "bf16x1")
    x3 = _plain(cp.maps_mma, torch.from_numpy(img), xt, yt, "col", "fp32", "bf16x3")
    tall = torch.from_numpy(np.pad(img, ((0, 0), (R, R), (0, 0)), mode="reflect"))
    rows = cp.row_pass_plain(tall, xt).abs()
    C = torch.from_numpy(cp.col_conv_matrix(np.abs(yt), H, H + 2 * R))
    bound = [1.01 * 2.0**-8 * (C[k] @ rows[:, k]).numpy() + 1e-3 for k in range(7)]
    # the v2 outputs: the sum of the 7 basis values, g2a - g2b, g2c - h2a
    tols = [sum(bound), bound[0] + bound[1], bound[2] + bound[3]]
    for g, w, t in zip(got, presplit["col"], tols):
        assert np.all(np.abs(g - w) <= t)
    g2a_g2b = front["col_default"][0] - front["col_default"][1]
    assert np.all(np.abs(got[1] - g2a_g2b) <= tols[1])
    figures = _rel_scale(got, presplit["col"])
    _report(record_property, "M bf16x1 col vs presplit col (rel to scale)", figures)
    assert min(figures) > max(_rel_scale(x3, presplit["col"]))


def test_torch_probe_mma_rowmxu_matches_script(scripts, taps, record_property):
    """profile_variants' rowmxu in interpret mode: the same taps split hi/lo
    against the bf16-rounded image (exact on its u8-valued input here), its
    column pass fp32 on the CPU against M's bf16x3: max/mean <= 5e-3, the
    reference's bar for its bf16x3 kernel against fp32."""
    xt, yt = taps
    img = _image(integers=True)
    _, _, once = scripts["profile_variants"].build("rowmxu", lax.Precision.HIGHEST, B, H, W, TILE)
    want = _np(once(_pad(img, rows=True)))
    got = _plain(cp.maps_mma, torch.from_numpy(img), xt, yt, "full", "mma", "bf16x3")
    figures = _rel_mean(got, want)
    _report(record_property, "M rowmxu vs profile_variants rowmxu (max/mean)", figures)
    assert max(figures) <= 5e-3


def test_torch_probe_mma_wrapper_refuses_unbuilt_cases(taps):
    xt, yt = taps
    img = torch.zeros((1, 16, 16))
    for case in [("row", "mma", "bf16x3"), ("coeff", "fp32", "bf16x1"), ("full", "mma", "bf16x1")]:
        assert case not in cp.MMA_CASES
        with pytest.raises(ValueError):
            cp.maps_mma(img, xt, yt, *case)


# ---------------------------------------------------------------------------
# utils/profiling.py and the probes' entry points
# ---------------------------------------------------------------------------


def test_torch_profiling_without_a_card(tmp_path):
    """Without a card spans still record into the ring, the memory figures
    are empty and the device timers raise; under a CPU profiler a span
    still shows in the host's Chrome trace."""
    assert not torch.cuda.is_available()
    with profiling.annotate("span"), profiling.annotate("step", tick=3):
        x = torch.ones(4) * 2
    assert float(x.sum()) == 8.0
    span, step = profiling.spans()[-2:]
    assert (span.name, step.name, step.parent, step.attrs) == ("span", "step", span.index, {"tick": 3})
    hw = profiling.MemoryHighWater()
    assert hw.sample() == {} and hw.peak == {} and hw.samples == 1
    assert profiling.device_memory_stats() == {}
    with pytest.raises(RuntimeError):
        profiling.device_events(lambda: torch.ones(3), reps=1)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("traced_span"):
            torch.ones(8).sum()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert '"traced_span"' in (tmp_path / "trace.json").read_text()


def test_torch_profiling_kernel_names():
    """kernel_named matches a CUDA function's demangled and mangled names and
    not a longer name that ends in it."""
    demangled = "void (anonymous namespace)::maps_kernel<4, (anonymous namespace)::T, float>(float const*)"
    assert profiling.kernel_named(demangled, "maps_kernel")
    assert not profiling.kernel_named(demangled.replace("::maps", "::mma_maps"), "maps_kernel")
    assert profiling.kernel_named("_ZN12_GLOBAL__N_111maps_kernelE", "maps_kernel")


def test_torch_profiling_kernel_names_of_kernels_b_and_f():
    """The names chip_smoke.py times kernels B and F by match their template
    instantiations and nothing else of the library."""
    assert profiling.kernel_named("void (anonymous namespace)::pyr_down_kernel<3, true>(float const*)",
                                  "pyr_down_kernel")
    assert profiling.kernel_named("void (anonymous namespace)::adj_kernel<4>(float const*)", "adj_kernel")
    assert not profiling.kernel_named("void (anonymous namespace)::filter_bank_kernel<4>(float const*)",
                                      "adj_kernel")


def test_torch_probes_untimed_walks_each_call_once():
    """Inside probes.untimed() the probes' timer calls its function once and
    returns NaN, so a measure() makes each call of its path once (phase 8's
    launch counts); outside it times as before."""
    from cvsteer_tpu_torch import probes
    from cvsteer_tpu_torch.probes import profile_v2_stages

    calls = []
    with probes.untimed():
        assert np.isnan(probes.time_ms(lambda: calls.append(1), "cuda", ("maps_kernel",)))
    assert calls == [1]
    assert not np.isnan(probes.time_ms(lambda: calls.append(1), "cpu"))
    assert len(calls) == 4  # the host clock's median of 3
    with probes.untimed():
        res = profile_v2_stages.measure("cpu", batch=1, size=16)
    assert all(np.isnan(us) for _, us in res["stages"]) and np.isnan(res["entry_us"])


class _Evt:
    """A kineto event as the device window reads it."""

    def __init__(self, name, corr, dur_ns=0, start_ns=0):
        self._n, self._c, self._d, self._s = name, corr, dur_ns, start_ns

    def name(self):
        return self._n

    def correlation_id(self):
        return self._c

    def duration_ns(self):
        return self._d

    def start_ns(self):
        return self._s


@pytest.mark.parametrize("names, per_call, events", [((), None, None), (("maps_kernel",), 2, None),
                                                     ((), None, 3)])
def test_torch_device_ms_retries_empty_windows(monkeypatch, names, per_call, events):
    """device_ms takes ONE window and holds it to its launches: a full
    window gives the mean device time per call; a window that misses a
    launch's device event, or sees fewer events of the named kernels than
    per_call * reps (or, for a graph replay of ``events`` device events,
    fewer than events * reps in all), raises ShortWindowError with both
    counts. Nothing is retaken and no other clock stands in.
    The profiler is stubbed: each window's launches and device events come
    from a list."""
    windows, opened = [], []

    @contextlib.contextmanager
    def fake_window():
        win = profiling.DeviceWindow()
        opened.append(win)
        yield win
        win.launches, win.events = windows.pop(0)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(profiling, "device_window", fake_window)
    reps, per = 4, per_call or events or 1
    kernel = "void (anonymous namespace)::maps_kernel<4>(float const*)"
    if events:  # one graph launch a call, its kernels under its correlation id
        launches = [_Evt("cudaGraphLaunch", c) for c in range(reps)]
        events_ = [_Evt(kernel, c // per, dur_ns=2500) for c in range(per * reps)]
    else:
        launches = [_Evt("cudaLaunchKernel", c) for c in range(per * reps)]
        events_ = [_Evt(kernel, c, dur_ns=2500) for c in range(per * reps)]
    windows[:] = [(launches, events_)]
    ms, seen = profiling.device_ms(lambda: None, names, per_call, reps=reps, events=events)
    assert (ms, seen) == (pytest.approx(2500e-6 * per), per) and len(opened) == 1
    if events:  # every replay seen, but the first one lost one of its kernels
        windows[:] = [(launches, events_[1:])]
        with pytest.raises(profiling.ShortWindowError, match=f"saw {per * reps - 1} device events in all, "
                                                             f"not {per * reps}"):
            profiling.device_ms(lambda: None, names, per_call, reps=reps, events=events)
        assert len(opened) == 2 and windows == []
        return
    windows[:] = [(launches, events_[1:])]  # the first launch's event dropped
    with pytest.raises(profiling.ShortWindowError, match=f"no device event for 1 of its {per * reps} launches"):
        profiling.device_ms(lambda: None, names, per_call, reps=reps)
    assert len(opened) == 2 and windows == []
    if names:  # every launch seen, but one of them is another kernel
        other = [_Evt("void other_kernel<1>(float)", 0)] + events_[1:]
        windows[:] = [(launches, other)]
        with pytest.raises(profiling.ShortWindowError, match=f"saw {per * reps - 1} .* not {per * reps}"):
            profiling.device_ms(lambda: None, names, per_call, reps=reps)
        assert len(opened) == 3


def test_torch_device_window_checks_graph_launches():
    """A profiled window of several graphs (a VO run's T and P) holds each
    graph launch to the events of one of the graphs that may run there: a
    replay that lost one of its kernels raises with both counts."""
    win = profiling.DeviceWindow()
    win.launches = [_Evt("cudaGraphLaunch", 0), _Evt("cudaLaunchKernel", 1), _Evt("cudaGraphLaunch", 2)]
    win.events = ([_Evt("t_kernel", 0)] * 3 + [_Evt("features", 1)] + [_Evt("p_kernel", 2)] * 5)
    assert win.graph_events() == [3, 5]
    win.check(graphs=[3, 5])
    with pytest.raises(profiling.ShortWindowError, match=r"1 graph launches with \[5\] device events; "
                                                         r"its graphs make \[3, 4\]"):
        win.check(graphs=[3, 4])
    win.events = win.events[1:]  # T's replay lost a kernel
    with pytest.raises(profiling.ShortWindowError, match=r"\[2\] device events"):
        win.check(graphs=[3, 5])


def test_torch_device_window_pads_both_sides(monkeypatch):
    """device_window launches its primers, then keeps WINDOW_PAD_S of idle
    time before the block and, after synchronizing, after it (the H100's
    device-to-host clock conversion wanders by about a millisecond, and
    kineto drops device events it places outside the window); it keeps the
    runtime's launch calls made inside the block and their device events,
    and nothing else."""
    calls = []
    zeros = torch.zeros
    monkeypatch.setattr(profiling, "_cuda", lambda: True)
    monkeypatch.setattr(torch, "zeros", lambda n, device=None: calls.append(("primer", n)) or zeros(n))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: calls.append("sync"))
    monkeypatch.setattr(profiling.time, "sleep", lambda s: calls.append(s))
    with profiling.device_window() as win:
        calls.append("block")
        torch.ones(8).sum()
    assert calls == [("primer", 1), profiling.WINDOW_PAD_S, "block", "sync", profiling.WINDOW_PAD_S]
    assert profiling.WINDOW_PAD_S >= 0.01
    assert win.events == [] and win.launches == [] and win.unseen() == []
    win.check()
    assert profiling.LAUNCH_API.match("cudaLaunchKernel") and profiling.LAUNCH_API.match("cuLaunchKernelEx")
    assert profiling.LAUNCH_API.match("cudaMemcpyAsync") and profiling.LAUNCH_API.match("cudaGraphLaunch")
    assert not profiling.LAUNCH_API.match("cudaStreamSynchronize")


@pytest.mark.parametrize("name", ["probe_dma_gather", "profile_v2_stages", "profile_frontend",
                                  "probe_r3_variants", "profile_variants"])
def test_torch_probe_entry_points(name, capsys):
    """Each probe refuses to run without a card unless --device cpu is given;
    with it, it times the plain versions, says so on its first line, and
    prints its script's table."""
    mod = importlib.import_module(f"cvsteer_tpu_torch.probes.{name}")
    assert mod.main([]) != 0
    assert "no CUDA GPU" in capsys.readouterr().err
    if name == "probe_dma_gather":
        return  # its shapes are the script's; the CPU run of the gathers is above
    assert mod.main(["--device", "cpu", "--batch", "1", "--size", "40"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("cpu: the kernels' plain versions")
    header = {"profile_v2_stages": "| stage |", "profile_frontend": "| stage |",
              "probe_r3_variants": "| tile | variant |", "profile_variants": "| variant |"}[name]
    assert any(line.startswith(header) for line in out)


def test_torch_probe_mma_full_tolerance_covers_sum_order(taps, record_property):
    """Why kernel M's full maps have a tolerance of their own
    (ops.cuda_probes.mma_agreement): a change of every basis value by 1e-6
    of the sum of its terms' sizes, what fp32 sums in another order (the
    tensor cores') can give, moves the maps of the sqrt steering by more
    than 1e-5 of scale at near-isotropic pixels, while the col-stage outputs
    (linear in the basis) move by less than 1e-5 of their scale. The stated
    full-map tolerance covers what such a change does."""
    xt, yt = taps
    img = torch.from_numpy(np.random.default_rng(5).uniform(0, 255, (2, 256, 256)).astype(np.float32))
    basis = cp.filter_bank_plain(img, xt, yt)
    sizes = cp.filter_bank_plain(img, np.abs(xt), np.abs(yt))
    gen = torch.Generator().manual_seed(0)
    moved = basis + 1e-6 * sizes * torch.randn(basis.shape, generator=gen)
    c2, c3 = cp.g2_harmonic(basis)
    want = cp.g2_sqrt_maps(basis, c2, c3)
    got = cp.g2_sqrt_maps(moved, *cp.g2_harmonic(moved))
    res = cp.mma_agreement(got, want, "full", "fp32", c3)
    cols = cp.mma_agreement(cp.col_outputs(moved, "v2"), cp.col_outputs(basis, "v2"), "col", "fp32")
    _report(record_property, "M full maps under a 1e-6 change of the basis (max, beyond 1e-5, firm max)",
            [res["max_rel"], res["beyond_1e-5"], res["firm_max_rel"]])
    assert res["max_rel"] > 1e-5 and cols["ok"]
    assert res["ok"]
