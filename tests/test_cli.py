"""CLI + checkpoint/resume."""

import os

import numpy as np

from miniraytracer_tpu.cli import build_parser, main
from miniraytracer_tpu.utils.checkpoint import save_checkpoint, load_checkpoint
from miniraytracer_tpu.utils.image import load_png


def test_parser_defaults_match_reference():
    # cmdline_parser.h:5-18
    a = build_parser().parse_args([])
    assert (a.width, a.height, a.samples, a.tilesize, a.depth, a.scene, a.mode) == (
        500, 500, 128, 32, 32, 8, 1,
    )
    assert a.maxlum == 1000.0


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "ck.npz")
    frame = np.random.default_rng(0).uniform(size=(64, 3)).astype(np.float32)
    save_checkpoint(p, frame, 7, {"width": 8, "height": 8, "scene": 2})
    f2, s2, cfg = load_checkpoint(p)
    np.testing.assert_array_equal(frame, f2)
    assert s2 == 7 and cfg["scene"] == 2


def test_cli_end_to_end_and_resume(tmp_path):
    out1 = str(tmp_path / "a.png")
    out2 = str(tmp_path / "b.png")
    ck = str(tmp_path / "ck.npz")
    # full progressive run with checkpoints
    main(["-scene", "2", "-width", "24", "-height", "24", "-samples", "4",
          "-depth", "3", "-mode", "1", "-checkpoint", ck,
          "-checkpoint-every", "2", "-out", out1])
    assert os.path.exists(out1) and os.path.exists(ck)
    # interrupted run: resume from pass 2 checkpoint and finish
    frame_full, s_full, _ = load_checkpoint(ck)
    save_ck = str(tmp_path / "ck2.npz")
    # re-run only the first 2 passes to produce a mid-way checkpoint
    main(["-scene", "2", "-width", "24", "-height", "24", "-samples", "4",
          "-depth", "3", "-mode", "1", "-checkpoint", save_ck,
          "-checkpoint-every", "2", "-out", out2])
    f_a = np.asarray(load_checkpoint(ck)[0])
    f_b = np.asarray(load_checkpoint(save_ck)[0])
    np.testing.assert_allclose(f_a, f_b, atol=1e-6)  # deterministic re-render


def test_cli_wavefront_writes_image(tmp_path):
    out = str(tmp_path / "w.png")
    main(["-scene", "5", "-width", "20", "-height", "20", "-samples", "1",
          "-depth", "2", "-renderer", "wavefront", "-out", out])
    im = load_png(out)
    assert im.shape == (20, 20, 3)
    assert im.max() > 0


def test_checkpoint_path_without_npz_roundtrips(tmp_path):
    # np.savez appends '.npz' on save; load must normalize the same way
    p = str(tmp_path / "bare")
    frame = np.random.default_rng(1).uniform(size=(16, 3)).astype(np.float32)
    written = save_checkpoint(p, frame, 3, {"scene": 1})
    assert written.endswith(".npz") and os.path.exists(written)
    f2, s2, cfg = load_checkpoint(p)  # bare path resolves too
    np.testing.assert_array_equal(frame, f2)
    assert s2 == 3


def test_cli_progressive_reports_mrays(capsys, tmp_path):
    out = str(tmp_path / "m.png")
    main(["-scene", "2", "-width", "16", "-height", "16", "-samples", "4",
          "-depth", "2", "-mode", "1", "-out", out])
    cap = capsys.readouterr().out
    assert "Mrays/s" in cap  # main.cpp:403-406: throughput in every mode
    assert "us/ray" in cap


def test_cli_preview_hilbert_matches_whole_frame(tmp_path):
    """-preview sweeps each pass in inverted-Hilbert tile batches; the final
    image must equal the whole-frame progressive render exactly (same
    per-(pixel,sample) keys, same merge), and the preview file must exist."""
    out_a = str(tmp_path / "a.png")
    out_b = str(tmp_path / "b.png")
    pv = str(tmp_path / "pv.png")
    common = ["-scene", "2", "-width", "24", "-height", "20", "-samples", "4",
              "-depth", "3", "-mode", "1", "-tilesize", "8"]
    main(common + ["-out", out_a])
    main(common + ["-out", out_b, "-preview", pv])
    assert os.path.exists(pv)
    a = load_png(out_a).astype(np.int32)
    b = load_png(out_b).astype(np.int32)
    assert np.abs(a - b).max() <= 1  # u8 rounding of identical floats


def test_cli_live_terminal_view(capsys, tmp_path):
    """-live paints ANSI truecolor half-block frames per pass (the
    reference window's headless stand-in, platform_linux.cpp:76-86)."""
    from miniraytracer_tpu.cli import main

    out = tmp_path / "o.png"
    main(["-scene", "2", "-width", "32", "-height", "32", "-samples", "4",
          "-depth", "3", "-renderer", "progressive", "-live",
          "-out", str(out)])
    s = capsys.readouterr().out
    assert "\x1b[2J" in s  # cleared once
    assert "\x1b[38;2;" in s and "\x1b[48;2;" in s  # truecolor fg+bg
    assert s.count("▀") > 100  # half-block cells
    assert out.exists()


def test_ansi_frame_shape_and_codes():
    import numpy as np

    from miniraytracer_tpu.utils.terminal import ansi_frame

    img = np.zeros((37, 53, 3), np.float32)
    img[..., 0] = 1.0
    s = ansi_frame(img, cols=40)
    lines = s.split("\n")
    assert all(line.endswith("\x1b[0m") for line in lines)
    assert all(line.count("▀") == 40 for line in lines)
    # red image -> red channel saturated in the codes
    assert "38;2;255;0;0" in s
