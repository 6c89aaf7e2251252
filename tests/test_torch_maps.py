"""The port's dense-map path against the reference package, on CPU.

Kernel E (ops.cuda_frontend.g2_maps / g4_maps) and kernel F
(filter_bank_adjoint, the backward of filter_bank_diff) take their plain
PyTorch versions for CPU tensors; these tests hold those plain versions, and
every function of the port's filters/g2.py, filters/g4.py,
features/pyramid_maps.py and utils/imageproc.py, to the reference's
functions on the same numpy inputs. Where the reference reaches a Pallas
kernel it runs in interpret mode, as its own suite runs it on CPU. The
kernels themselves run against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsteer_tpu.features import pyramid_maps as jpm
from cvsteer_tpu.filters import g2 as jg2
from cvsteer_tpu.filters import g4 as jg4
from cvsteer_tpu.ops.pallas_frontend import _g4_quad_terms, g2_maps_tiled_pallas, g4_maps_pallas
from cvsteer_tpu.ops.sepconv import filter_bank_xla
from cvsteer_tpu.utils import imageproc as jip
from cvsteer_tpu_torch.features import pyramid_maps as tpm
from cvsteer_tpu_torch.filters import g2 as tg2
from cvsteer_tpu_torch.filters import g4 as tg4
from cvsteer_tpu_torch.ops import cuda_frontend as cf
from cvsteer_tpu_torch.ops.sepconv import filter_bank_plain
from cvsteer_tpu_torch.utils import convert
from cvsteer_tpu_torch.utils import imageproc as tip

torch.set_num_threads(2)

MAPS = ("edges", "lines_dark", "lines_bright")


@pytest.fixture(scope="module")
def crop(fish_gray):
    return np.ascontiguousarray(fish_gray[40:104, 40:200])  # the reference tests' crop


def _texture(seed, shape):
    img = np.random.default_rng(seed).random(shape).astype(np.float32) * 255
    return cv2.GaussianBlur(img.reshape(-1, shape[-1]), (0, 0), 1.2).reshape(shape)


def _rel(got, want) -> float:
    """max |got - want| / mean |want|: the reference tests' map measure."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / (np.abs(want).mean() + 1e-6))


def _report(record_property, what, figures, fmt="{:.2e}"):
    """Print a measured parity figure (shown under pytest -s) and record it
    (kept by --junitxml): PERF.md quotes these numbers."""
    text = " / ".join(fmt.format(x) for x in figures)
    print(f"\nparity {what}: {text}")
    record_property(what, text)


def _wrapped(d):
    """Angle difference folded into [-pi, pi)."""
    return np.remainder(d + math.pi, 2 * math.pi) - math.pi


@pytest.mark.parametrize("ref", ["pallas_tiled", "xla_pipeline"])
def test_torch_g2_maps_plain_matches_reference(crop, ref, record_property):
    """The reference's bar, max/mean < 5e-3 (tests/test_pallas_frontend.py:
    92-111), against its bf16x3 kernel and against its fp32 pipeline. The
    steered maps are ill-conditioned at near-isotropic pixels, and the
    reference's XLA convolution does not sum in a fixed order, so the fp32
    figure is reported (edges / dark / bright), not asserted tighter; the
    xla case also reports how far a 1e-6 relative change of the basis moves
    the maps (20 draws, worst)."""
    bank = jg2.g2_bank()
    batch = np.stack([crop, crop[::-1].copy()])
    if ref == "pallas_tiled":
        want = g2_maps_tiled_pallas(jnp.asarray(batch), bank.xtaps, bank.ytaps, tile_h=16)
    else:
        m = jg2.steerable_pipeline_g2(jnp.asarray(batch), bank, method="xla")
        want = (m.edges, m.lines_dark, m.lines_bright)
    got = cf.g2_maps(torch.from_numpy(batch), bank.xtaps, bank.ytaps)
    figures = [_rel(g.numpy(), w) for g, w in zip(got, want)]
    _report(record_property, f"G2 maps vs {ref}", figures)
    for g, figure, name in zip(got, figures, MAPS):
        assert g.shape == (2, 64, 160) and g.dtype == torch.float32
        assert figure < 5e-3, name
    if ref == "xla_pipeline":
        basis = tg2.g2_basis(torch.from_numpy(batch))
        m0 = tg2.g2_maps_from_basis(basis)
        worst = [0.0] * 3
        for seed in range(20):
            noise = np.random.default_rng(seed).standard_normal(basis.shape).astype(np.float32)
            m1 = tg2.g2_maps_from_basis(basis * (1 + 1e-6 * torch.from_numpy(noise)))
            worst = [max(w, _rel(getattr(m1, n).numpy(), getattr(m0, n).numpy()))
                     for w, n in zip(worst, MAPS)]
        _report(record_property, "G2 maps after a 1e-6 relative basis change", worst)


def test_torch_g2_maps_flat_image_steers_to_zero():
    """c2 = c3 = 0 must steer to theta = 0 (arctan2(0, 0) / 2), not pi/4:
    tests/test_pallas_frontend.py:66-80 at its atol 1e-6."""
    bank = jg2.g2_bank()
    flat = np.full((32, 160), 0.5, np.float32)
    m = jg2.steerable_pipeline_g2(jnp.asarray(flat), bank, method="xla")
    for fn in (cf.g2_maps, cf.g2_maps_plain):
        for g, w in zip(fn(torch.from_numpy(flat), bank.xtaps, bank.ytaps),
                        (m.edges, m.lines_dark, m.lines_bright)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_torch_g2_maps_bf16_outputs(crop):
    """bfloat16 maps are the float32 maps rounded: within 2^-8 of each
    pixel (tests/test_pallas_frontend.py:114-131)."""
    bank = tg2.g2_bank()
    img = torch.from_numpy(crop)
    f32 = cf.g2_maps(img, bank.xtaps, bank.ytaps)
    b16 = cf.g2_maps(img, bank.xtaps, bank.ytaps, out_dtype=torch.bfloat16)
    for a, b in zip(f32, b16):
        assert b.dtype == torch.bfloat16
        assert ((a - b.float()).abs() <= a.abs() * 2.0**-8 + 1e-6).all()
        assert torch.equal(b, a.to(torch.bfloat16))  # round to nearest even
    with pytest.raises(TypeError):
        cf.g2_maps(img, bank.xtaps, bank.ytaps, out_dtype=torch.float16)


@pytest.mark.parametrize("ref", ["pallas", "xla_pipeline"])
def test_torch_g4_maps_plain_matches_reference(crop, ref, record_property):
    """Bar < 1e-2 (tests/test_pallas_frontend.py:189-206) against the
    reference's fused G4 kernel and against its fp32 G4 pipeline + find_*
    (figures reported, edges / dark / bright)."""
    bank = jg4.g4_bank()
    if ref == "pallas":
        want = g4_maps_pallas(jnp.asarray(crop), bank.xtaps, bank.ytaps)
    else:
        m = jg4.steerable_pipeline_g4(jnp.asarray(crop), bank, method="xla")
        want = (jg2.find_edges(m.magnitude, m.phase), jg2.find_dark_lines(m.magnitude, m.phase),
                jg2.find_bright_lines(m.magnitude, m.phase))
    got = cf.g4_maps(torch.from_numpy(crop), bank.xtaps, bank.ytaps)
    figures = [_rel(g.numpy(), w) for g, w in zip(got, want)]
    _report(record_property, f"G4 maps vs {ref}", figures)
    for figure, name in zip(figures, MAPS):
        assert figure < 1e-2, name


def test_torch_g4_product_list_and_tables_bit_equal():
    for a, b in zip(jg4._energy_quadratic_tables(), tg4._energy_quadratic_tables()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert tg4.g4_quad_terms() == tuple(_g4_quad_terms()) and len(tg4.g4_quad_terms()) == 33
    # kernel E's list: the same products in the same order, each with the
    # one weight the reference kernel keeps (|w| > 1e-7), exact in float32
    live = cf.g4_live_terms()
    assert [(i, j) for i, j, _, _ in live] == [(i, j) for i, j, _, _ in _g4_quad_terms()]
    for (i, j, slot, w), (_, _, w2, w3) in zip(live, _g4_quad_terms()):
        assert w == (w2, w3)[slot] and abs((w2, w3)[1 - slot]) <= 1e-7
    assert sorted(slot for _, _, slot, _ in live) == [0] * 18 + [1] * 15
    jb, tb = jg4.g4_bank(), tg4.g4_bank()
    got = convert.g4_bank(jb)
    np.testing.assert_array_equal(got.xtaps, tb.xtaps)
    np.testing.assert_array_equal(got.ytaps, tb.ytaps)
    assert (got.width, got.spacing, got.radius) == (tb.width, tb.spacing, 6)


def test_torch_g2_functions_match_reference():
    img = _texture(11, (2, 40, 52))
    bank = jg2.g2_bank()
    jb = filter_bank_xla(jnp.asarray(img), bank.xtaps, bank.ytaps)
    tb = torch.from_numpy(np.array(jb))
    scale = float(np.abs(np.asarray(jb)).max())
    close = lambda a, b, tol=1e-5: np.abs(  # noqa: E731
        np.asarray(a, np.float64) - b.numpy()).max() <= tol * max(np.abs(np.asarray(a)).max(), 1e-30)

    # basis: kernel A's plain version, differentiable wrapper
    assert close(jb, tg2.g2_basis(torch.from_numpy(img)))
    for theta in (0.3, np.random.default_rng(1).uniform(-3, 3, (2, 40, 52)).astype(np.float32)):
        jt = theta if np.isscalar(theta) else jnp.asarray(theta)
        tt = theta if np.isscalar(theta) else torch.from_numpy(theta)
        for a, b in zip(jg2.steer(jb, jt), tg2.steer(tb, tt)):
            assert close(a, b)
        jc, tc = jg2.energy_coefficients(jb), tg2.energy_coefficients(tb)
        assert close(jg2.oriented_energy(*jc, jt), tg2.oriented_energy(*tc, tt))
    for a, b in zip(jg2.steer_at(jb, 5, 7, 0.4), tg2.steer_at(tb, 5, 7, 0.4)):
        assert close(a, b)
    ja, ta = jg2.analyze_at(jb, 9, 3, -1.1), tg2.analyze_at(tb, 9, 3, -1.1)
    for a, b, tol in zip(ja, ta, (scale, scale, scale**2, scale)):  # g2, h2, e, magnitude
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-5 * tol
    assert np.abs(_wrapped(ta[4].numpy() - np.asarray(ja[4]))).max() <= 1e-4  # phase
    ang = np.linspace(0, 2 * math.pi, 97, dtype=np.float32)
    assert close(jg2.wrap_angle(jnp.asarray(ang)), tg2.wrap_angle(torch.from_numpy(ang)))

    g2v = np.random.default_rng(2).standard_normal((40, 52)).astype(np.float32)
    h2v = np.random.default_rng(3).standard_normal((40, 52)).astype(np.float32)
    (jm, jp), (tm, tp) = jg2.magnitude_phase(g2v, h2v), tg2.magnitude_phase(
        torch.from_numpy(g2v), torch.from_numpy(h2v))
    assert close(jm, tm) and np.abs(_wrapped(tp.numpy() - np.asarray(jp))).max() <= 1e-6
    phase = np.array(jp)
    for phi, signum in ((math.pi / 2, False), (0.0, True), (math.pi, True), (1.0, False)):
        a = jg2.phase_weights(jnp.asarray(phase), phi, signum, k=5.0)
        b = tg2.phase_weights(torch.from_numpy(phase), phi, signum, k=5.0)
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6
    for name in ("find_edges", "find_dark_lines", "find_bright_lines"):
        a = getattr(jg2, name)(jm, jnp.asarray(phase))
        b = getattr(tg2, name)(tm, torch.from_numpy(phase))
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-5 * float(np.asarray(jm).max())

    # the whole pipeline: every field on the same image. Orientation-odd
    # fields (h2, phase, theta) are compared where the orientation is firm:
    # |(c2, c3)| well above 0, and away from the half-angle's singular point
    # c3 ~ 0 with c2 < 0 (theta = +-pi/2), where theta's sign, and with it
    # h2's, is rounding noise in both packages. The steered maps (g2 and the
    # three outputs) take the reference's map bar: near-isotropic pixels
    # make them ill-conditioned in the basis.
    jmaps = jg2.steerable_pipeline_g2(jnp.asarray(img), bank, method="xla")
    tmaps = tg2.steerable_pipeline_g2(torch.from_numpy(img))
    _, c2, c3 = (np.asarray(c) for c in jg2.energy_coefficients(jb))
    firm = (np.hypot(c2, c3) > 1e-3 * np.hypot(c2, c3).max()) & ~(
        (np.abs(c3) < 1e-3 * np.abs(c3).max()) & (c2 < 0))
    for field in tg2.G2Maps._fields:
        a, b = np.asarray(getattr(jmaps, field)), getattr(tmaps, field).numpy()
        assert a.shape == b.shape, field
        if field in ("h2", "phase", "theta"):
            d = _wrapped(b - a) if field == "phase" else b - a
            tol = 1e-3 if field == "phase" else 1e-4 * max(np.abs(a).max(), 1.0)
            assert np.abs(d)[firm].max() <= tol, field
            assert firm.mean() > 0.9
        elif field in ("g2",) + MAPS:
            assert _rel(b, a) < 5e-3, field
        else:
            assert np.abs(b - a).max() <= 1e-4 * np.abs(a).max(), field
    precise = tg2.g2_output_maps(torch.from_numpy(img), accuracy="precise", out_dtype=torch.bfloat16)
    fast = tg2.g2_output_maps(torch.from_numpy(img))
    for p, f, name in zip(precise, fast, MAPS):
        assert p.dtype == torch.bfloat16 and f.dtype == torch.float32
        assert torch.equal(p, getattr(tmaps, name).to(torch.bfloat16))
        assert _rel(f.numpy(), getattr(jmaps, name)) < 5e-3, name
    with pytest.raises(ValueError):
        tg2.g2_output_maps(torch.from_numpy(img), accuracy="bf16")


def test_torch_g4_functions_match_reference():
    img = _texture(12, (36, 44))
    bank = jg4.g4_bank()
    jb = filter_bank_xla(jnp.asarray(img), bank.xtaps, bank.ytaps)
    tb = torch.from_numpy(np.array(jb))
    scale = float(np.abs(np.asarray(jb)).max())
    assert np.abs(tg4.g4_basis(torch.from_numpy(img)).numpy() - np.asarray(jb)).max() <= 1e-5 * scale

    def close(a, b, tol=1e-5):
        a = np.asarray(a)
        return np.abs(a - b.numpy()).max() <= tol * max(np.abs(a).max(), 1e-30)

    theta_map = np.random.default_rng(4).uniform(-2, 2, (36, 44)).astype(np.float32)
    for th_j, th_t in ((0.7, 0.7), (jnp.asarray(theta_map), torch.from_numpy(theta_map))):
        (ga, ha), (gt, ht) = jg4.steering_coefficients(th_j), tg4.steering_coefficients(th_t)
        for a, b in zip(ga + ha, gt + ht):
            assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6
        for a, b in zip(jg4.steer(jb, th_j), tg4.steer(tb, th_t)):
            assert close(a, b)
        assert close(jg4.oriented_energy(jb, th_j), tg4.oriented_energy(tb, th_t))
    g4v, h4v = (np.asarray(a) for a in jg4.steer(jb, 0.2))
    (jm, jp), (tm, tp) = jg4.magnitude_phase(g4v, h4v), tg4.magnitude_phase(
        torch.from_numpy(g4v), torch.from_numpy(h4v))
    assert close(jm, tm) and np.abs(_wrapped(tp.numpy() - np.asarray(jp))).max() <= 1e-5

    (ja0, jas, jbs), (ta0, tas, tbs) = jg4.energy_harmonics(jb), tg4.energy_harmonics(tb)
    for a, b in zip([ja0, *jas, *jbs], [ta0, *tas, *tbs]):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-5 * float(np.asarray(ja0).max())
    jc, tc = jg4.energy_coefficients(jb), tg4.energy_coefficients(tb)
    for a, b in zip(jc, tc):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-5 * float(np.asarray(jc[0]).max())
    # the quadratic tables reproduce the sampled harmonics (a0, a1, b1)
    for a, b in zip(tc, (ta0, tas[0], tbs[0])):
        assert np.abs(a.numpy() - b.numpy()).max() <= 1e-4 * float(ta0.max())
    (jt, js), (tt, ts) = jg4.dominant_orientation(*jc[1:]), tg4.dominant_orientation(*tc[1:])
    assert close(js, ts, 1e-4)

    jmaps = jg4.steerable_pipeline_g4(jnp.asarray(img), bank, method="xla")
    tmaps = tg4.steerable_pipeline_g4(torch.from_numpy(img))
    c2, c3 = np.asarray(jc[1]), np.asarray(jc[2])
    firm = (np.hypot(c2, c3) > 1e-3 * np.hypot(c2, c3).max()) & ~(
        (np.abs(c3) < 1e-3 * np.abs(c3).max()) & (c2 < 0))
    assert firm.mean() > 0.9
    for field in tg4.G4Maps._fields:
        a, b = np.asarray(getattr(jmaps, field)), getattr(tmaps, field).numpy()
        if field in ("h4", "phase", "theta"):  # H4 is odd: its sign follows theta's
            d = _wrapped(b - a) if field == "phase" else b - a
            tol = 1e-3 if field == "phase" else 1e-3 * max(np.abs(a).max(), 1.0)
            assert np.abs(d)[firm].max() <= tol, field
        elif field == "g4":  # steered: the G4 map bar
            assert _rel(b, a) < 1e-2, field
        else:
            assert np.abs(b - a).max() <= 1e-3 * np.abs(a).max(), field


def test_torch_pyramid_maps_match_reference():
    img = _texture(13, (24, 30))  # levels 24x30, 12x15, 6x8 (smaller than G4's pad)
    jl = jpm.steerable_pyramid_maps(jnp.asarray(img), levels=3, method="xla")
    tl = tpm.steerable_pyramid_maps(torch.from_numpy(img), levels=3)
    assert len(tl) == len(jl) == 3
    for (jg2m, jg4m), t in zip(jl, tl):
        for field in ("magnitude", "strength", "energy") + MAPS:
            a, b = np.asarray(getattr(jg2m, field)), getattr(t.g2, field).numpy()
            assert a.shape == b.shape
            if field in MAPS:
                assert _rel(b, a) < 5e-3, field
            else:
                assert np.abs(b - a).max() <= 1e-4 * np.abs(a).max() + 1e-3, field
        for field in ("magnitude", "strength", "energy"):
            a, b = np.asarray(getattr(jg4m, field)), getattr(t.g4, field).numpy()
            assert np.abs(b - a).max() <= 1e-3 * np.abs(a).max() + 1e-3, field
    assert all(t.g4 is None for t in tpm.steerable_pyramid_maps(torch.from_numpy(img), levels=2,
                                                               with_g4=False))


@pytest.mark.parametrize("order", [2, 4])
def test_torch_filter_bank_diff_gradient_matches_jax(crop, order, record_property):
    """d sum(basis^2) / d image through the port's differentiable basis vs
    jax.grad through the reference's g{2,4}_basis(method="pallas") (Pallas
    forward in interpret mode, XLA VJP): bar < 1e-3 of scale
    (tests/test_pallas_frontend.py:155-186)."""
    jmod, tmod = (jg2, tg2) if order == 2 else (jg4, tg4)
    basis_fn = getattr(jmod, f"g{order}_basis")
    img = crop[:32, :48]
    g_ref = np.asarray(jax.grad(lambda im: jnp.sum(basis_fn(im, method="pallas") ** 2))(jnp.asarray(img)))
    x = torch.from_numpy(img.copy()).requires_grad_()
    (g,) = torch.autograd.grad((getattr(tmod, f"g{order}_basis")(x) ** 2).sum(), x)
    err = np.abs(g.numpy() - g_ref).max() / (np.abs(g_ref).max() + 1e-9)
    _report(record_property, f"G{order} basis gradient vs jax.grad", [err])
    assert err < 1e-3


@pytest.mark.parametrize("shape", [(2, 20, 31), (3, 5), (2, 2), (1, 1), (7, 4)])
@pytest.mark.parametrize("bank_fn", ["g2_bank", "g4_bank"])
def test_torch_filter_bank_adjoint_plain_is_the_adjoint(shape, bank_fn):
    """The explicit adjoint against autograd through the plain bank,
    including levels smaller than the pad (the fold wraps more than once):
    fp32 sums in another order, bar 1e-5 of scale; and <g, A x> = <A^T g, x>
    in float64."""
    bank = getattr(tg2 if bank_fn == "g2_bank" else tg4, bank_fn)()
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random(shape).astype(np.float32) * 255).requires_grad_()
    out = filter_bank_plain(x, bank.xtaps, bank.ytaps)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    (ref,) = torch.autograd.grad(out, x, g)
    got = cf.filter_bank_adjoint(g, bank.xtaps, bank.ytaps)
    assert got.shape == x.shape
    lhs = float((g.double() * out.detach().double()).sum())
    rhs = float((got.double() * x.detach().double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs) + 1e-3
    # sums over the whole bank cancel at a 1x1 level: scale by the terms
    terms = float((g.abs().sum() * np.abs(bank.xtaps).max() * np.abs(bank.ytaps).max()))
    assert (got - ref).abs().max().item() <= 1e-5 * max(ref.abs().max().item(), terms / g.numel())


def test_torch_imageproc_matches_reference(fish_gray):
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 17, 23)) * 40).astype(np.float32)
    for axes in (None, (-2, -1)):
        a = np.asarray(jip.normalize_minmax_u8(jnp.asarray(x), axes=axes))
        b = tip.normalize_minmax_u8(torch.from_numpy(x), axes=axes).numpy()
        np.testing.assert_array_equal(a, b)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(jip.normalize_minmax_u8(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16))),
        tip.normalize_minmax_u8(bf).numpy())
    np.testing.assert_array_equal(tip.normalize_minmax_u8(torch.zeros((4, 4))).numpy(), 0)
    for gain in (0.05, 3.0):
        np.testing.assert_array_equal(np.asarray(jip.convert_scale_u8(jnp.asarray(x), gain)),
                                      tip.convert_scale_u8(torch.from_numpy(x), gain).numpy())
    half = np.array([0.5, 1.5, 2.5, 254.5], np.float32)  # half to even, as rint
    np.testing.assert_array_equal(tip.convert_scale_u8(torch.from_numpy(half), 1.0).numpy(),
                                  [0, 2, 2, 254])
    bgr = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    got = tip.bgr_to_gray_f32(torch.from_numpy(bgr)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jip.bgr_to_gray_f32(jnp.asarray(bgr))))
    assert np.abs(got - cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)).max() <= 1
