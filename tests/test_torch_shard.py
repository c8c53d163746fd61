"""tpuenc_torch.shard, the striped multi-device encode, against tpuenc on
the CPU, byte for byte (integer arithmetic: tolerance 0).

The ranks are processes joined in gloo process groups
(``tpuenc_torch.testing.dist.launch``): one group per mesh shape, (1, 4)
and (2, 2), each running every case of its list once in a module-scoped
fixture (``tpuenc_torch.testing.shard_cases.run_cases``); each case is
asserted in its own test.  tpuenc runs its striped steps on 4 of the 8
virtual CPU devices (XLA), its general pack in interpret mode, and its
whole files on its host path (``TPUENC_DEVICE_ENTROPY=0``, the conftest's
default).
"""

from __future__ import annotations

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import tpuenc  # noqa: E402
import tpuenc_torch as tt  # noqa: E402
from tpuenc.core.tables import default_tables  # noqa: E402
from tpuenc.core.types import EncoderConfig as JaxConfig  # noqa: E402
from tpuenc.entropy.device_encode import tables_to_device  # noqa: E402
from tpuenc.entropy.pallas_pack import pack_tables  # noqa: E402
from tpuenc.shard import stripes as jstripes  # noqa: E402
from tpuenc.shard.mesh import make_mesh as jax_mesh  # noqa: E402
from tpuenc_torch.core.types import EncoderConfig  # noqa: E402
from tpuenc_torch.shard import stripes  # noqa: E402
from tpuenc_torch.testing.dist import launch  # noqa: E402
from tpuenc_torch.testing.shard_cases import (  # noqa: E402
    apply_settings,
    case_images,
    fail_on_rank,
    run_cases,
)

OPT = ("set_optimized_huffman_tables", True)
PROG = ("set_progressive", True)


def _ids(value):
    return value["name"] if isinstance(value, dict) else None


def _case(name, kind, quality, settings, w, h, ct="RGB", seeds=(0,), **kw):
    return dict(name=name, kind=kind, quality=quality, settings=settings,
                w=w, h=h, color_type=ct, seeds=list(seeds), **kw)


# (1, 4).  48x128 at 2x2 is 8 MCU rows, 2 a stripe (6 MCUs); 48x80 is 5
# MCU rows over 4 stripes (2, 2, 1 and 0 real rows).
FILES_14 = [
    _case("default", "encode", 85, [], 48, 128),
    _case("restart5", "encode", 85, [("set_restart_interval", 5)], 48, 128),
    _case("restart4_crosses_stripes", "encode", 85,
          [("set_restart_interval", 4)], 48, 128),
    _case("sequential_f41", "encode", 85, [("set_sampling_factor", "F_4_1")],
          64, 128),
    _case("progressive", "encode", 85, [PROG], 48, 128),
    _case("optimized", "encode", 85, [OPT], 48, 128),
    _case("optimized_progressive", "encode", 85, [PROG, OPT], 48, 128),
    _case("luma", "encode", 85, [], 48, 128, "LUMA"),
    _case("cmyk_as_ycck_420", "encode", 90, [("set_sampling_factor", "F_2_2")],
          48, 128, "CMYK_AS_YCCK"),
    _case("rows5_over_4", "encode", 85, [], 48, 80),
    _case("rows5_over_4_optimized", "encode", 85, [OPT], 48, 80),
]
STEPS_14 = [
    _case("step_sequential", "step", 85, [OPT], 48, 80),
    _case("step_progressive_ycck", "step", 90, [PROG, OPT,
          ("set_sampling_factor", "F_2_2")], 48, 128, "CMYK_AS_YCCK"),
]
# 32x48 at 2x2: 3 MCU rows over 4 stripes, the last all padding.
PACK_14 = _case("pack_interleaved", "pack", 85, [], 32, 48, budget=16)

# (2, 2): two batch coordinates of two stripes.  tpuenc takes more images
# than batch coordinates on its coefficient route; the port packs them all
# on the general route, k a coordinate.
FILES_22 = [
    _case("general_2", "encode", 75, [], 32, 64, seeds=(0, 1)),
    _case("coefficients_4_optimized", "encode", 75, [OPT], 32, 64,
          seeds=(0, 1, 2, 3)),
    _case("general_6_progressive_restart3", "encode", 80,
          [PROG, ("set_restart_interval", 3)], 32, 64, seeds=range(6)),
]
STEPS_22 = [
    _case("step22_sequential", "step", 85, [OPT], 48, 80, seeds=(0, 1, 2, 3)),
    _case("step22_progressive", "step", 85, [PROG, OPT], 48, 128,
          seeds=(4, 5, 6, 7)),
]
ROUTES_22 = [
    (_case("route_general", "route", 75, [], 32, 64, n=2), "sharded-general"),
    (_case("route_coefficients", "route", 75, [], 32, 64, n=4),
     "sharded-general"),
    (_case("route_unaligned", "route", 75, [], 50, 64, n=2),
     "ValueError: sharded encode requires MCU-aligned dimensions"),
    (_case("route_indivisible", "route", 75, [], 32, 64, n=3),
     "ValueError: batch 3 is not a positive multiple of the mesh batch "
     "axis 2"),
    (_case("route_empty", "route", 75, [], 32, 64, n=0),
     "ValueError: batch 0 is not a positive multiple"),
]
DRYRUN_22 = _case("dryrun", "dryrun", 0, [], 0, 0)

CASES_14 = FILES_14 + STEPS_14 + [PACK_14]
CASES_22 = FILES_22 + STEPS_22 + [c for c, _ in ROUTES_22] + [DRYRUN_22]


@pytest.fixture(scope="module")
def ranks14():
    return launch(run_cases, 4, (1, CASES_14, "cpu"), timeout=300)


@pytest.fixture(scope="module")
def ranks22():
    return launch(run_cases, 4, (2, CASES_22, "cpu"), timeout=300)


def _tpuenc_encoder(case):
    enc = tpuenc.Encoder(case["quality"])
    apply_settings(enc, case["settings"], tpuenc.SamplingFactor)
    return enc


def _torch_encoder(case):
    enc = tt.Encoder(case["quality"], device="cpu")
    apply_settings(enc, case["settings"], tt.SamplingFactor)
    return enc


def _check_files(ranks, case, route):
    files, path, _, _ = ranks[0][case["name"]]
    assert path == route
    for r in ranks[1:]:  # every rank returns every file
        assert r[case["name"]][0] == files
    ct = case["color_type"]
    for img, got in zip(case_images(case), files):
        args = (img, case["w"], case["h"])
        assert got == _tpuenc_encoder(case).encode(
            *args, getattr(tpuenc.ColorType, ct))
        assert got == _torch_encoder(case).encode(
            *args, getattr(tt.ColorType, ct))


@pytest.mark.parametrize("case", FILES_14, ids=_ids)
def test_files_over_1x4(ranks14, case):
    """Whole files over four stripes equal tpuenc's and the single-device
    encoder's, in every mode."""
    _check_files(ranks14, case, "sharded-general")


@pytest.mark.parametrize("case", FILES_22, ids=_ids)
def test_files_over_2x2(ranks22, case):
    """Two batch coordinates, each with one image, two with optimized
    tables, or three progressive with restart segments across stripes:
    image k * b + i on coordinate b, every file on every rank."""
    _check_files(ranks22, case, "sharded-general")


def _jax_step(case, n_batch):
    enc = _tpuenc_encoder(case)
    ct = getattr(tpuenc.ColorType, case["color_type"])
    mesh = jax_mesh(4, batch=n_batch, devices=jax.devices()[:4])
    fn, geo = jstripes.stripe_encode_step(case["w"], case["h"], ct,
                                          enc._config(), mesh,
                                          with_histograms=True)
    coeff, hists = fn(jstripes.pad_for_stripes(
        np.stack(case_images(case)), geo,
        channels=case["color_type"] != "LUMA"))
    return ([np.asarray(c) for c in coeff],
            [(np.asarray(dc), np.asarray(ac)) for dc, ac in hists])


@pytest.mark.parametrize("n_batch,case", [(1, c) for c in STEPS_14]
                         + [(2, c) for c in STEPS_22],
                         ids=_ids)
def test_stripe_step_matches_tpuenc(ranks14, ranks22, n_batch, case):
    """The coefficient step: every stripe's streams (gathered on every
    rank) and each image's histograms reduced over its stripes equal
    tpuenc's ``stripe_encode_step`` on a 4-device mesh, uneven stripes
    included."""
    ranks = ranks14 if n_batch == 1 else ranks22
    coeff, hists = _jax_step(case, n_batch)
    n_s = 4 // n_batch
    per = len(case["seeds"]) // n_batch
    gathered, _, n_local = ranks[0][case["name"]]
    for r, result in enumerate(ranks):
        got, got_hists, _ = result[case["name"]]
        for mine, theirs in zip(got, gathered):
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(a, b)
        b, s = divmod(r, n_s)
        for k, n in enumerate(n_local):
            mine = gathered[r][k].reshape(64, per, n).transpose(1, 2, 0)
            want = coeff[k][b * per:(b + 1) * per, s * n:(s + 1) * n]
            np.testing.assert_array_equal(mine, want)
        for i in range(per):
            for t, (dc, ac) in enumerate(hists):
                np.testing.assert_array_equal(got_hists[i, t, 0], dc[b * per + i])
                np.testing.assert_array_equal(got_hists[i, t, 1], ac[b * per + i])


def test_stripe_pack_matches_tpuenc(ranks14):
    """One stripe's part of an interleaved scan with no restart interval,
    the last stripe all padding: its total bits, each block's bits and
    its words equal tpuenc's general per-stripe pack (interpret mode)."""
    case = PACK_14
    enc = _tpuenc_encoder(case)
    mesh = jax_mesh(4, batch=1, devices=jax.devices()[:4])
    fn, geo, _, local_counts = jstripes._build_general_pack_fn(
        case["w"], case["h"], tpuenc.ColorType.RGB, enc._config(), mesh,
        case["budget"])
    dcp, acp = pack_tables(tuple(
        np.asarray(t) for t in tables_to_device(
            [list(p) for p in default_tables()])))
    ((stream, meta, lens),) = fn(
        jstripes.pad_for_stripes(np.stack(case_images(case)), geo),
        np.asarray(dcp)[None], np.asarray(acp)[None])
    stream, meta, lens = map(np.asarray, (stream, meta, lens))
    for s, result in enumerate(ranks14):
        ((bits, got_lens, words),) = result[case["name"]]
        assert meta[0, s, 0] == 0 and bits == meta[0, s, 1]
        np.testing.assert_array_equal(got_lens[:local_counts[0]], lens[0, s])
        np.testing.assert_array_equal(
            words.view(np.uint32),
            stream[0, s, :words.size].view(np.uint32))
    assert ranks14[3][case["name"]][0][0] == 0  # the padding stripe


@pytest.mark.parametrize("case,want", ROUTES_22,
                         ids=_ids)
def test_route_is_chosen_up_front(ranks22, case, want):
    for result in ranks22:
        assert result[case["name"]].startswith(want)


def test_dryrun_multichip(ranks22):
    """The port's twin of ``__graft_entry__.dryrun_multichip`` on a (2, 2)
    mesh: the stripe step with histograms, and the general route with
    optimized tables, restart interval 1 and 3 progressive scans, each
    equal to the single-device encoder."""
    for result in ranks22:
        assert result["dryrun"]["mesh"] == [2, 2]
        assert result["dryrun"] == ranks22[0]["dryrun"]


def test_a_failing_rank_fails_the_launch_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose") as err:
        launch(fail_on_rank, 2, (1,), timeout=60)
    assert "Traceback" in str(err.value)
    assert time.monotonic() - t0 < 60


_SIZES = [(8, 8), (16, 16), (17, 33), (48, 128), (50, 75), (258, 172),
          (64, 40)]
_TYPES = ["RGB", "LUMA", "CMYK_AS_YCCK", "YCBCR"]
_SAMPLINGS = ["F_1_1", "F_2_2", "F_4_1", "F_2_1", "F_1_2", "F_4_2"]


def _configs():
    for sampling in _SAMPLINGS:
        yield (EncoderConfig(sampling_factor=getattr(tt.SamplingFactor, sampling)),
               JaxConfig(sampling_factor=getattr(tpuenc.SamplingFactor,
                                                 sampling)))


def _component_fields(components):
    return [(c.id, c.quantization_table, c.dc_huffman_table,
             c.ac_huffman_table, c.horizontal_sampling_factor,
             c.vertical_sampling_factor) for c in components]


@pytest.mark.parametrize("n_stripes", [1, 2, 4, 8])
def test_stripe_geometry_matches_tpuenc(n_stripes):
    for w, h in _SIZES:
        for ct in _TYPES:
            for config, jconfig in _configs():
                got = stripes.stripe_geometry(w, h, getattr(tt.ColorType, ct),
                                              config, n_stripes)
                want = jstripes.stripe_geometry(
                    w, h, getattr(tpuenc.ColorType, ct), jconfig, n_stripes)
                assert _component_fields(got.pop("components")) == \
                    _component_fields(want.pop("components"))
                assert got == want


@pytest.mark.parametrize("n_stripes", [1, 2, 4, 8])
def test_stripe_padding_matches_tpuenc(n_stripes):
    """Each stripe's own padding equals tpuenc's whole padded canvas cut
    at the stripe, stripes below the image included."""
    for (w, h), ct in [((50, 75), "RGB"), ((17, 33), "LUMA"),
                       ((64, 40), "CMYK_AS_YCCK"), ((48, 128), "RGB")]:
        case = _case("pad", "pad", 85, [], w, h, ct, seeds=(3, 4))
        images = case_images(case)
        for config, jconfig in _configs():
            geo = stripes.stripe_geometry(w, h, getattr(tt.ColorType, ct),
                                          config, n_stripes)
            canvas = jstripes.pad_for_stripes(
                np.stack(images), jstripes.stripe_geometry(
                    w, h, getattr(tpuenc.ColorType, ct), jconfig, n_stripes),
                channels=ct != "LUMA")
            rows = stripes.stripe_pixel_rows(geo)
            for s in range(n_stripes):
                got = stripes.pad_stripe(images, geo, s, "cpu").numpy()
                np.testing.assert_array_equal(
                    got, canvas[:, s * rows:(s + 1) * rows])


@pytest.mark.parametrize("entry", ["encode_image", "encode_stream",
                                   "new_file", "new_writer"])
def test_single_device_entry_points_refuse(entry):
    """The entry points that would run the single-device path on every
    rank raise, naming the sharded ones."""
    from tpuenc_torch.shard.encode import ShardedEncoder

    enc = ShardedEncoder(85, None, device="cpu")
    with pytest.raises(NotImplementedError, match="encode_batch"):
        getattr(enc, entry)(None, 8, 8, tt.ColorType.RGB)
    if entry.startswith("new_"):
        with pytest.raises(NotImplementedError, match=entry):
            getattr(ShardedEncoder, entry)("out.jpg", 85, device="cpu")
