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

``ShardedEncoder`` does what ``tpuenc``'s does: its striped methods and
``encode`` return ``tpuenc``'s files, None or ``ValueError`` case by case
(held to ``tpuenc``'s own ``ShardedEncoder`` and ``tpuenc.Encoder``);
``encode_image`` and ``encode_stream`` are ``Encoder``'s; a batch the
striped route does not take is ``Encoder.encode_batch``'s, whose files
the tests hold to ``tpuenc.Encoder``'s.  (``tpuenc``'s inherited
``encode_batch`` returns those files on its default device path; on its
host path it goes image by image through ``ShardedEncoder.encode``, which
raises for them.)
"""

from __future__ import annotations

import io
import time

import numpy as np
import pytest
import torch

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
    planes_buffer,
    run_cases,
)

OPT = ("set_optimized_huffman_tables", True)
PROG = ("set_progressive", True)


def _ids(value):
    return value["name"] if isinstance(value, dict) else None


def _case(name, kind, quality, settings, w, h, ct="RGB", seeds=(0,), **kw):
    return dict(name=name, kind=kind, quality=quality, settings=settings,
                w=w, h=h, color_type=ct, seeds=list(seeds), **kw)


def _call(name, method, quality, settings, w, h, seeds=(0, 1), **kw):
    return _case(name, "encode", quality, settings, w, h, seeds=seeds,
                 method=method, **kw)


RESTART = "set_restart_interval"


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
# encode_image and encode_stream, Encoder's own on every rank.
ENTRY_14 = _case("entry14", "entry", 85, [], 48, 128, seeds=(7,))
# encode of one image: the striped route, or tpuenc's ValueError.
ONE_14 = [
    _call("encode_one_14", "encode", 85, [], 48, 128, seeds=(0,)),
    _call("encode_unaligned_14", "encode", 85, [], 30, 130, seeds=(0,)),
]

# (2, 2): two batch coordinates of two stripes.  tpuenc takes more images
# than batch coordinates on its coefficient route; the port packs them all
# on the general route, k a coordinate.
FILES_22 = [
    _case("general_2", "encode", 75, [], 32, 64, seeds=(0, 1)),
    _case("coefficients_4_optimized", "encode", 75, [OPT], 32, 64,
          seeds=(0, 1, 2, 3)),
    _case("general_6_progressive_restart3", "encode", 80,
          [PROG, ("set_restart_interval", 3)], 32, 64, seeds=range(6)),
    # Batches the striped route does not take: Encoder.encode_batch's.
    _case("encoder_batch_3", "encode", 90, [], 32, 64, seeds=(0, 1, 2),
          route="device-batch"),
    _case("encoder_unaligned_3", "encode", 90, [], 50, 36, seeds=(3, 4, 5),
          route="device-batch"),
    _case("encoder_optimized_3", "encode", 85, [OPT], 32, 64,
          seeds=(6, 7, 8), route="device-batch-per-image"),
]
ENTRY_22 = _case("entry22", "entry", 80, [PROG], 32, 64, seeds=(8,))
# tpuenc's named striped methods, each with tpuenc's domain: files, None
# or ValueError (tests/test_sharded_general_pack.py,
# tests/test_sharded_encode.py).  32x64 at 2x2 is 4 MCU rows, 2 a stripe
# of 4 MCUs.
GENERAL = "encode_batch_packed_general"
PACKED = "encode_batch_packed"
SHARDED = "encode_batch_sharded"
NAMED_22 = [
    (_call("packed_general_2", GENERAL, 85, [], 32, 64), "files"),
    (_call("packed_general_2_restart7", GENERAL, 85, [(RESTART, 7)], 32, 64),
     "files"),
    (_call("packed_general_4", GENERAL, 85, [], 32, 64, seeds=range(4)), None),
    (_call("packed_general_unaligned", GENERAL, 85, [], 30, 130), None),
    (_call("packed_restart4", PACKED, 85, [(RESTART, 4)], 32, 64), "files"),
    (_call("packed_restart1", PACKED, 80, [(RESTART, 1)], 32, 64), "files"),
    (_call("packed_no_restart", PACKED, 85, [], 32, 64), None),
    (_call("packed_restart3", PACKED, 85, [(RESTART, 3)], 32, 64), None),
    (_call("packed_rows_3_over_2", PACKED, 85, [(RESTART, 2)], 32, 48),
     None),
    (_call("packed_progressive", PACKED, 85, [PROG, (RESTART, 2)], 32, 64),
     None),
    (_call("packed_4", PACKED, 85, [(RESTART, 4)], 32, 64, seeds=range(4)),
     None),
    (_call("packed_unaligned", PACKED, 85, [(RESTART, 4)], 50, 36), None),
    (_call("sharded_4", SHARDED, 75, [], 32, 64, seeds=range(4)), "files"),
    (_call("sharded_4_optimized", SHARDED, 85, [OPT], 32, 64,
           seeds=range(4)), "files"),
    (_call("sharded_3", SHARDED, 75, [], 32, 64, seeds=range(3)),
     "ValueError"),
    (_call("sharded_unaligned", SHARDED, 75, [], 50, 36), "ValueError"),
    (_call("sharded_empty", SHARDED, 75, [], 32, 64, seeds=()),
     "ValueError"),
    (_call("encode_one_22", "encode", 85, [], 32, 64, seeds=(0,)),
     "ValueError"),
    (_call("encode_unaligned_22", "encode", 85, [], 50, 36, seeds=(0,)),
     "ValueError"),
]
STEPS_22 = [
    _case("step22_sequential", "step", 85, [OPT], 48, 80, seeds=(0, 1, 2, 3)),
    _case("step22_progressive", "step", 85, [PROG, OPT], 48, 128,
          seeds=(4, 5, 6, 7)),
]
# (the route of encode_batch's plan, route or its ValueError).  The route
# takes a stripe of any size: config 5 (16384x16384 YCCK 4:2:0) over (2, 2)
# is 5,242,880 blocks a stripe, past plan.DEVICE_BLOCK_LIMIT.
UNALIGNED = "ValueError: sharded encode requires MCU-aligned dimensions"
ROUTES_22 = [
    (_case("route_general", "route", 75, [], 32, 64, n=2),
     ("sharded-general", "sharded-general")),
    (_case("route_coefficients", "route", 75, [], 32, 64, n=4),
     ("sharded-general", "sharded-general")),
    (_case("route_unaligned", "route", 75, [], 50, 64, n=2),
     ("device-batch", UNALIGNED)),
    (_case("route_indivisible", "route", 75, [], 32, 64, n=3),
     ("device-batch", "ValueError: batch 3 is not a positive multiple of "
      "the mesh batch axis 2")),
    (_case("route_empty", "route", 75, [], 32, 64, n=0),
     ("device-batch", "ValueError: batch 0 is not a positive multiple")),
    (_case("route_indivisible_optimized", "route", 75, [OPT], 32, 64, n=3),
     ("device-batch-per-image", "ValueError: batch 3 is not")),
    (_case("route_past_limits", "route", 90, [("set_sampling_factor",
                                                "F_2_2")],
           16384, 16384, "CMYK_AS_YCCK", n=2),
     ("sharded-general", "sharded-general")),
]
DRYRUN_22 = _case("dryrun", "dryrun", 0, [], 0, 0)

CASES_14 = FILES_14 + STEPS_14 + [PACK_14, ENTRY_14] + ONE_14
CASES_22 = (FILES_22 + STEPS_22 + [c for c, _ in ROUTES_22]
            + [c for c, _ in NAMED_22] + [DRYRUN_22, ENTRY_22])


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


def _check_files(ranks, case):
    files, path, _, _ = ranks[0][case["name"]]
    assert path == case.get("route", "sharded-general")
    for r in ranks[1:]:  # every rank returns every file
        assert r[case["name"]][:2] == (files, path)
    ct = case["color_type"]
    images = case_images(case)
    assert len(files) == len(images)
    for img, got in zip(images, files):
        args = (img, case["w"], case["h"])
        assert got == _tpuenc_encoder(case).encode(
            *args, getattr(tpuenc.ColorType, ct))
        assert got == _torch_encoder(case).encode(
            *args, getattr(tt.ColorType, ct))
    if path != "sharded-general":  # Encoder.encode_batch's route and name
        enc = _torch_encoder(case)
        enc.encode_batch(images, case["w"], case["h"],
                         getattr(tt.ColorType, ct))
        assert enc.last_encode_path == path


@pytest.mark.parametrize("case", FILES_14 + ONE_14[:1], ids=_ids)
def test_files_over_1x4(ranks14, case):
    """Whole files over four stripes equal tpuenc's and the single-device
    encoder's, in every mode; ``encode`` of one image too."""
    _check_files(ranks14, case)


@pytest.mark.parametrize("case", FILES_22, ids=_ids)
def test_files_over_2x2(ranks22, case):
    """Two batch coordinates, each with one image, two with optimized
    tables, or three progressive with restart segments across stripes:
    image k * b + i on coordinate b, every file on every rank.  A batch
    the striped route does not take (3 images, or images that are not
    MCU-aligned) is ``Encoder.encode_batch``'s, on its route."""
    _check_files(ranks22, case)


def _tpuenc_sharded_call(case, n_batch):
    """``tpuenc``'s ``ShardedEncoder`` method of the case on a (n_batch,
    4 // n_batch) mesh of 4 virtual devices: its files, None, or
    "ValueError"."""
    from tpuenc.shard.encode import ShardedEncoder as JaxSharded

    enc = JaxSharded(case["quality"],
                     jax_mesh(4, batch=n_batch, devices=jax.devices()[:4]))
    apply_settings(enc, case["settings"], tpuenc.SamplingFactor)
    images = case_images(case)
    args = (case["w"], case["h"], getattr(tpuenc.ColorType,
                                          case["color_type"]))
    try:
        if case["method"] == "encode":
            return [enc.encode(images[0], *args)]
        return getattr(enc, case["method"])(images, *args)
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("n_batch,case,want",
                         [(2, c, w) for c, w in NAMED_22]
                         + [(1, ONE_14[1], "ValueError")], ids=_ids)
def test_named_methods_match_tpuenc(ranks14, ranks22, n_batch, case, want):
    """``tpuenc``'s striped methods and ``encode`` of one image, each with
    ``tpuenc``'s domain: where ``tpuenc``'s returns files, the port's
    equal them (and ``tpuenc.Encoder``'s) on every rank; where it returns
    None or raises ``ValueError``, so does the port's."""
    ranks = ranks14 if n_batch == 1 else ranks22
    theirs = _tpuenc_sharded_call(case, n_batch)
    files = ranks[0][case["name"]][0]
    for r in ranks[1:]:
        assert r[case["name"]][0] == files
    if want != "files":
        assert theirs == want
        assert (files is None if want is None
                else files.startswith("ValueError: "))
        return
    assert files == theirs
    _check_files(ranks, case)


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


@pytest.mark.parametrize("case,want", ROUTES_22, ids=_ids)
def test_route_is_chosen_up_front(ranks22, case, want):
    """The plan's route: the striped route where ``route`` takes the batch
    (a stripe past the whole-image limits included), else
    ``Encoder.encode_batch``'s route name; ``encode_batch([])`` is []."""
    for result in ranks22:
        batch_route, route, empty = result[case["name"]]
        assert batch_route == want[0]
        assert route.startswith(want[1])
        assert empty == ([] if case["n"] == 0 else None)
    if want[0] != "sharded-general":
        enc = _torch_encoder(case)
        assert enc._plan(case["w"], case["h"],
                         getattr(tt.ColorType, case["color_type"]),
                         n=case["n"]).route == want[0]


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


@pytest.mark.parametrize("n_batch,entry,route", [
    (1, "encode_image", "device-v2"),
    (1, "encode_stream", "device-chunked-stream"),
    (2, "encode_image", "device-v2"),
    (2, "encode_stream", "device-v2")])
def test_inherited_entry_points_match_tpuenc(ranks14, ranks22, n_batch,
                                            entry, route):
    """``encode_image`` and ``encode_stream`` are ``Encoder``'s, on every
    rank's device: ``tpuenc.Encoder``'s bytes, on ``Encoder``'s route
    (the interleaved stream in bands, the progressive one scan by
    scan)."""
    ranks, case = (ranks14, ENTRY_14) if n_batch == 1 else (ranks22, ENTRY_22)
    (image,) = case_images(case)
    ref = _tpuenc_encoder(case)
    if entry == "encode_image":
        want = ref.encode_image(planes_buffer(
            image, tpuenc.ImageBuffer, tpuenc.JpegColorType.YCBCR))
    else:
        want = b"".join(ref.encode_stream(image, case["w"], case["h"],
                                          tpuenc.ColorType.RGB))
    for result in ranks:
        got, path = result[case["name"]][entry]
        assert got == want
        assert path == route


@pytest.mark.parametrize("package", ["tpuenc", "tpuenc_torch"])
@pytest.mark.parametrize("entry", ["new_file", "new_writer"])
def test_sinks_raise_type_error(tmp_path, package, entry):
    """``new_file`` and ``new_writer`` cannot build a ``ShardedEncoder``
    (its ``__init__`` takes a mesh): ``TypeError``, in ``tpuenc`` as in the
    port."""
    if package == "tpuenc":
        from tpuenc.shard.encode import ShardedEncoder
        kwargs = {}
    else:
        from tpuenc_torch.shard.encode import ShardedEncoder
        kwargs = {"device": "cpu"}
    sink = tmp_path / "out.jpg" if entry == "new_file" else io.BytesIO()
    with pytest.raises(TypeError):
        getattr(ShardedEncoder, entry)(sink, 85, **kwargs)
    assert not (tmp_path / "out.jpg").exists()


def test_stripe_segment_bits_past_2_31():
    """A stripe's bit counts past 2^31 (a noisy stripe at a high rung) stay
    exact: ``segment_bits`` sums the int32 block lengths in int64, for one
    segment and for restart segments that cross the stripe's edges."""
    lens = np.full(5, (1 << 30) + 7, dtype=np.int64)
    for seg_blocks, offset in ((0, 0), (2, 4), (3, 4)):
        first, segs = stripes.segment_bits(
            torch.from_numpy(lens.astype(np.int32)), 5, offset, seg_blocks)
        assert segs.dtype == torch.int64
        if seg_blocks == 0:
            assert (first, segs.tolist()) == (0, [int(lens.sum())])
            continue
        lead = offset % seg_blocks
        want = np.add.reduceat(np.concatenate([np.zeros(lead, np.int64),
                                               lens]),
                               np.arange(0, lead + 5, seg_blocks))
        assert first == offset // seg_blocks
        assert segs.tolist() == want.tolist()


def test_merge_rows_are_held_under_2_31_bits():
    """K3/K4's int32 row lengths (and K5's, which takes them) cannot wrap
    unflagged: every merge plan's last cap, for any stripe size and rung,
    is far under 2^31 bits, and a run past its last cap (here past 2^31
    bits) sets the overflow flag, so the ladder climbs or raises."""
    from tpuenc_torch.entropy import device_encode as de
    from tpuenc_torch.entropy import pallas_pack as pk

    for e in range(9, 32):
        for rung in de.BUDGET_LADDER:
            _, _, caps, caps_f = pk.merge_plan(
                1 << e, pk.final_block_cap(max(rung, 16)), rung)
            assert 32 * max(caps[-1], (caps_f or [0])[-1]) < 1 << 22
    lens = torch.full((4,), 1 << 30, dtype=torch.int32)
    words = torch.zeros((4, 2), dtype=torch.int32)
    _, _, ovf = pk.merge_rows_ref(words, lens, 4, 1, [64, 128], 128)
    assert ovf.tolist() == [1]
