"""End-to-end pipeline/CLI tests: file-in/file-out vs oracle byte streams."""

import numpy as np

from jeicyboodsp_tpu.io.wav import read_pcm16, write_pcm16, write_wav
from jeicyboodsp_tpu.pipelines import run_pipeline


def test_geq_pipeline(tmp_path, rng):
    n = 2048
    x = np.clip(rng.normal(0, 3000, n), -32768, 32767).astype(np.int16)
    inp, out = str(tmp_path / "in.wav"), str(tmp_path / "out.pcm")
    write_wav(inp, x, 48000)
    run_pipeline("geq", inp, out)
    from jeicyboodsp_tpu.oracle import geq as og

    np.testing.assert_array_equal(read_pcm16(out), og.run(x))


def test_wiener_pipeline_header_not_skipped(tmp_path, rng):
    n = 512 * 8
    x = np.clip(rng.normal(0, 20, n), -32768, 32767).astype(np.int16)
    inp, out = str(tmp_path / "in.pcm"), str(tmp_path / "out.pcm")
    write_pcm16(inp, x)
    run_pipeline("wiener", inp, out)
    from jeicyboodsp_tpu.oracle import enhance as oe

    np.testing.assert_array_equal(read_pcm16(out), oe.run(x, "wiener"))


def test_mfcc_gmm_chain(tmp_path):
    """MFCC list processing -> train -> classify, end to end on synthetic
    two-class audio."""
    rng = np.random.default_rng(2)  # hermetic: EM separability is seed-sensitive
    fs = 16000
    paths = []
    for ci, f0 in enumerate((200.0, 1800.0)):
        t = np.arange(1024 * 30) / fs
        # frequency- and amplitude-modulated tones + noise: feature frames
        # must VARY or the GMM covariances degenerate to zero (NaN scores,
        # faithfully reference-like but untestable)
        f = f0 * (1 + 0.2 * np.sin(2 * np.pi * 1.5 * t))
        amp = 6000 * (0.6 + 0.4 * np.sin(2 * np.pi * 2.2 * t) ** 2)
        x = np.clip(
            amp * np.sin(2 * np.pi * np.cumsum(f) / fs) + rng.normal(0, 500, len(t)),
            -32768,
            32767,
        ).astype(np.int16)
        wav = str(tmp_path / f"c{ci}.wav")
        mfc = str(tmp_path / f"c{ci}.mfc")
        write_wav(wav, x, fs)
        paths.append((wav, mfc))
    listfile = str(tmp_path / "mfcc_list.txt")
    open(listfile, "w").write("\n".join(f"{w} {m}" for w, m in paths))
    run_pipeline("mfcc", listfile)
    for _, m in paths:
        assert np.fromfile(m, dtype="<f8").size % 12 == 0

    # class lists (one feature file per class)
    class_lists = []
    for ci, (_, m) in enumerate(paths):
        cl = str(tmp_path / f"class{ci}.txt")
        open(cl, "w").write(m + "\n")
        class_lists.append(cl)
    train_list = str(tmp_path / "train.txt")
    open(train_list, "w").write("\n".join(class_lists))
    model = str(tmp_path / "model.bin")
    run_pipeline("gmm-train", train_list, model)

    # aligned-layout classification separates the classes
    results = run_pipeline("gmm-test", train_list, model, emulate_layout_mismatch=False)
    for ci, pred, _ in results:
        assert pred == ci, results


def test_gmm_test_scores_below_float32_range(tmp_path):
    """--fast (a float32 dtype, x64 off) still scores in float64: per-frame
    likelihoods near e^-150 underflow float32 to 0, whose log -inf would
    leave every decision on the incumbent class 1."""
    import jax
    import jax.numpy as jnp

    from jeicyboodsp_tpu.models import serialization as S
    from jeicyboodsp_tpu.oracle import gmm as ogmm

    ev = np.stack([np.eye(12)[:, :4]] * 4)
    cov = np.stack([np.eye(12)] * 4)

    def gmm(offset):
        mean = np.zeros((4, 12))
        mean[:, :4] = offset
        return np.full(4, 0.25), mean, cov, ev

    classes = [gmm(10.0), gmm(8.5)]  # ~-204 and ~-148 per frame
    model = tmp_path / "model.bin"
    model.write_bytes(b"".join(S.pack_gmm(*c) for c in classes))
    frames = np.random.default_rng(3).normal(0, 0.1, (32, 12))
    mfc = tmp_path / "t.mfc"
    frames.astype("<f8").tofile(mfc)
    lists = []
    for c in range(2):
        lst = tmp_path / f"t{c}.lst"
        lst.write_text(str(mfc))
        lists.append(str(lst))
    main = tmp_path / "test.lst"
    main.write_text("\n".join(lists))

    want = [ogmm.score_file(frames, a, m, np.stack([np.diag(c)[:4] for c in cv]), e)
            for a, m, cv, e in classes]
    assert want[1] > want[0] and max(want) < -103.0  # below float32's range
    with jax.enable_x64(False):
        results = run_pipeline("gmm-test", str(main), str(model), dtype=jnp.float32)
    assert [pred for _, pred, _ in results] == [1, 1]
    np.testing.assert_allclose(results[0][2], want, rtol=1e-9)


def test_cli_main(tmp_path, rng):
    """argparse entry point end to end (forced CPU)."""
    from jeicyboodsp_tpu.cli import main

    x = np.clip(rng.normal(0, 2000, 1536), -32768, 32767).astype(np.int16)
    inp, out = str(tmp_path / "in.wav"), str(tmp_path / "out.pcm")
    write_wav(inp, x, 48000)
    assert main(["geq", inp, out, "--cpu"]) == 0
    assert len(read_pcm16(out)) == 1536
    assert main(["nope", inp, out]) == 2


def test_speech_e2e_single_jit():
    """Audio in -> trained GMMs -> classification + HMM decode, all on
    device (no feature files)."""
    import jax.numpy as jnp

    from jeicyboodsp_tpu.pipelines.speech import speech_classify, speech_decode, speech_train

    rng = np.random.default_rng(5)
    fs, T, C = 16000, 24, 3
    audio = np.zeros((C, T, 1024), np.int16)
    for c in range(C):
        t = np.arange(T * 1024) / fs
        f0 = 250.0 * (c + 1)
        f = f0 * (1 + 0.2 * np.sin(2 * np.pi * 1.3 * t))
        amp = 6000 * (0.6 + 0.4 * np.sin(2 * np.pi * 2.1 * t) ** 2)
        x = np.clip(amp * np.sin(2 * np.pi * np.cumsum(f) / fs) + rng.normal(0, 400, len(t)), -32768, 32767)
        audio[c] = x.astype(np.int16).reshape(T, 1024)

    alpha, mean, cov, e8 = speech_train(jnp.asarray(audio), dtype=jnp.float64)
    e4 = e8[:, :, :, :4]
    for c in range(C):
        scores = np.asarray(speech_classify(jnp.asarray(audio[c]), alpha, mean, cov, e4, dtype=jnp.float64))
        assert int(np.argmax(scores)) == c, (c, scores)

    # HMM decode with states built from the trained class GMMs
    trans = jnp.asarray(np.full((6, 6), 1.0 / 6))
    sel = np.array([0, 1, 2, 0, 1, 2])
    path, score = speech_decode(
        jnp.asarray(audio[1]),
        alpha[sel], mean[sel], cov[sel], e4[sel], trans, dtype=jnp.float64, compat=False,
    )
    # class-1 states are 1 and 4; the corrected decoder should sit in them
    assert np.isin(np.asarray(path), [1, 4]).mean() > 0.9, np.asarray(path)
