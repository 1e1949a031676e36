"""The imagery receivers (APT, SSTV, WEFAX) of the port on the CPU against
the JAX package: the modulators, the device chains, the six golden outputs,
the host decoders, noise, the end-to-end inverse pairs and the three
offline decoders.

Bounds: the chains 2e-5 relative to the largest output, the golden
tolerance (tests/test_golden.py).  The SSTV and WEFAX frequency tracks are
compared from output 180: before that the 161-tap FIR ramps from zero
history, angle() of near-zero complex values is float32 rounding, and two
right implementations part there (the JAX package's own rule,
tests/test_sstv.py:97-102, tests/test_wefax.py:94-95).  Images decoded from
the same track are byte-exact with equal ``info``; images decoded from the
port's own track within 1 LSB; against the transmitted image the JAX tests'
bounds (APT median ≤ 3, q95 ≤ 12, tests/test_apt.py:68-69; SSTV and WEFAX
median ≤ 4, q95 ≤ 16)."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import csdr_tpu as cs
from csdr_tpu.apps import apt_decode as japt_app
from csdr_tpu.apps import sstv_decode as jsstv_app
from csdr_tpu.apps import wefax_decode as jwefax_app
from csdr_tpu.core.runtime import Pipeline as JaxPipeline
from csdr_tpu.models import apt as japt
from csdr_tpu.models import sstv as jsstv
from csdr_tpu.models import wefax as jwefax

import csdr_tpu_torch as ct
from csdr_tpu_torch.apps import apt_decode, sstv_decode, wefax_decode
from csdr_tpu_torch.models import apt, sstv, wefax

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 2e-5
WARMUP = 180
FS = {"apt": 8 * apt.WORD_RATE, "sstv": 11025.0, "wefax": 12000.0}
GOLD = os.path.join(os.path.dirname(__file__), "golden", "golden_anchors.npz")


def apt_image(lines=8, seed=0):
    """tests/test_apt.py's image: sync trains at spec levels, black spaces,
    smooth video, constant telemetry wedges."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((lines, apt.LINE_WORDS), np.float64)
    t = np.arange(909)
    for ln in range(lines):
        row = rows[ln]
        row[:39] = apt.SYNC_A * (244 - 11) + 11
        row[39:86] = 11
        row[86:995] = 128 + 110 * np.sin(2 * np.pi * (ln + 1) * t / 909 + rng.uniform(0, np.pi))
        row[995:1040] = 40 * (ln % 2) + 60
        row[1040:1079] = np.concatenate(
            [apt.SYNC_B, np.zeros(39 - len(apt.SYNC_B))]) * (244 - 11) + 11
        row[1079:1126] = 11
        row[1126:2035] = 128 + 90 * np.cos(2 * np.pi * 3 * t / 909)
        row[2035:] = 200
    return np.asarray(np.rint(rows), np.uint8)


def sstv_image(lines=4, px=320, seed=0):
    """tests/test_sstv.py's smooth RGB content."""
    rng = np.random.default_rng(seed)
    t = np.arange(px)
    img = np.zeros((lines, px, 3), np.float64)
    for ln in range(lines):
        img[ln, :, 0] = 128 + 100 * np.sin(2 * np.pi * t / px + ln * 0.3)
        img[ln, :, 1] = np.clip(255 * t / px, 0, 255)
        img[ln, :, 2] = 40 + 20 * (ln % 4) + 30 * np.cos(4 * np.pi * t / px + rng.uniform(0, 1))
    return np.asarray(np.rint(img), np.uint8)


def wefax_chart(lines=4, seed=0):
    """tests/test_wefax.py's chart (isobars as slow sinusoids)."""
    rng = np.random.default_rng(seed)
    t = np.arange(wefax.PX_PER_LINE)
    img = np.zeros((lines, wefax.PX_PER_LINE), np.float64)
    for ln in range(lines):
        img[ln] = 200 - 150 * (0.5 + 0.5 * np.sin(2 * np.pi * (ln + 2) * t / wefax.PX_PER_LINE
                                                  + rng.uniform(0, np.pi)))
    return np.asarray(np.rint(img), np.uint8)


MODELS = {"apt": (apt, japt), "sstv": (sstv, jsstv), "wefax": (wefax, jwefax)}


@pytest.fixture(scope="module")
def audio():
    return {"apt": apt.apt_modulate(apt_image(6, 1), FS["apt"]),
            "sstv": sstv.sstv_modulate(sstv_image(3, seed=1), FS["sstv"]),
            "wefax": wefax.wefax_modulate(wefax_chart(3, 1), FS["wefax"], phasing_lines=4)}


def receiver(kind, mod):
    return getattr(mod, f"{kind}_receiver")(FS[kind])


def run_port(graph, x, block):
    sink = ct.CollectSink()
    ct.Pipeline(graph, block_size=block, device=CPU).run(iter([x]), sink, num_samples=len(x))
    return np.asarray(sink.concat())


def run_jax(graph, x, block):
    sink = cs.CollectSink()
    JaxPipeline(graph, block_size=block, donate=False).run(iter([x]), sink, num_samples=len(x))
    return np.asarray(sink.concat())


def close(got, want, first=0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got[first:] - want[first:])) / np.max(np.abs(want))


def decode(kind, mod, track):
    fs = FS[kind]
    if kind == "apt":
        return mod.decode_words(track)
    return mod.decode_freq(track, fs)


@pytest.mark.parametrize("kind", list(MODELS))
def test_modulators_match_jax(kind):
    port, ref = MODELS[kind]
    img = {"apt": apt_image(2), "sstv": sstv_image(1), "wefax": wefax_chart(1)}[kind]
    got = getattr(port, f"{kind}_modulate")(img, FS[kind])
    assert np.array_equal(got, getattr(ref, f"{kind}_modulate")(img, FS[kind]))
    with pytest.raises(ValueError):
        getattr(port, f"{kind}_modulate")(np.zeros((2, 100), np.uint8), FS[kind])


@pytest.mark.parametrize("kind", list(MODELS))
def test_chain_matches_jax(audio, kind):
    """The device chain, streamed over several blocks with the state
    carried, against the JAX chain at the same block size (the APT carrier
    phase is one sum per block, so the partition matters)."""
    port, ref = MODELS[kind]
    x = audio[kind]
    block = 1 << 15
    got = run_port(receiver(kind, port), x, block)
    want = run_jax(receiver(kind, ref), x, block)
    assert close(got, want, 0 if kind == "apt" else WARMUP) < TOL


@pytest.fixture(scope="module")
def gold():
    if not os.path.exists(GOLD):
        pytest.skip("golden anchors not generated")
    return np.load(GOLD)


GOLDEN = {"apt": ("in_apt_audio", "apt_words", "apt_image", 1 << 16),
          "sstv": ("in_sstv_audio", "sstv_freq", "sstv_image", 1 << 15),
          "wefax": ("in_wefax_audio", "wefax_freq", "wefax_image", 1 << 15)}


@pytest.mark.parametrize("kind", list(GOLDEN))
def test_golden_imagery(gold, kind):
    """tests/test_golden.py:97-139: the pinned track at 2e-5, the pinned
    image byte-exact from the pinned track (ROADMAP Queue C: a byte-exact
    image from a track held to 2e-5 is not a fair anchor), and within 1 LSB
    from the port's own track."""
    port, ref = MODELS[kind]
    x_key, track_key, img_key, block = GOLDEN[kind]
    track = run_port(receiver(kind, port), gold[x_key], block)
    assert close(track, gold[track_key], 0 if kind == "apt" else WARMUP) < TOL
    img, info = decode(kind, port, gold[track_key])
    assert img.shape == gold[img_key].shape and np.array_equal(img, gold[img_key])
    if kind == "sstv":
        assert info["mode"] == "martin1"
    own, own_info = decode(kind, port, track)
    assert own.shape == img.shape and own_info["lines"] == info["lines"]
    assert np.max(np.abs(own.astype(int) - img)) <= 1


def _tracks(gold, kind):
    """Tracks to decode: the pinned one, the JAX chain's on fresh audio, and
    the same with a cut head (a recording started mid-transmission)."""
    port, ref = MODELS[kind]
    x = {"apt": japt.apt_modulate(apt_image(5, 7), FS["apt"]),
         "sstv": jsstv.sstv_modulate(sstv_image(2, seed=7), FS["sstv"], mode="martin2"),
         "wefax": jwefax.wefax_modulate(wefax_chart(2, 7), FS["wefax"], lpm=120.0)}[kind]
    fresh = run_jax(receiver(kind, ref), x, 1 << 15)
    return [gold[GOLDEN[kind][1]], fresh, fresh[len(fresh) // 7:]]


@pytest.mark.parametrize("kind", list(MODELS))
def test_decoders_match_jax(gold, kind):
    port, ref = MODELS[kind]
    for track in _tracks(gold, kind):
        img, info = decode(kind, port, track)
        jimg, jinfo = decode(kind, ref, track)
        assert img.dtype == jimg.dtype and np.array_equal(img, jimg)
        assert info == jinfo
    fs = FS[kind]
    t = gold[GOLDEN[kind][1]]
    if kind == "apt":
        assert np.array_equal(apt.find_sync(t), japt.find_sync(t))
        a, b = apt.split_channels(gold["apt_image"])
        ja, jb = japt.split_channels(gold["apt_image"])
        assert np.array_equal(a, ja) and np.array_equal(b, jb)
    elif kind == "sstv":
        assert sstv.decode_vis(t, fs) == jsstv.decode_vis(t, fs)
        assert np.array_equal(sstv.find_syncs(t, fs), jsstv.find_syncs(t, fs))
        assert sstv.decode_freq(t, fs, "martin2")[1] == jsstv.decode_freq(t, fs, "martin2")[1]
    else:
        assert wefax.find_phasing(t, fs) == jwefax.find_phasing(t, fs)
        assert wefax.decode_freq(t, fs, 90.0)[1] == jwefax.decode_freq(t, fs, 90.0)[1]


def test_noise_fabricates_no_lines():
    """tests/test_apt.py:83-91 and tests/test_wefax.py:55-59: noise of any
    length decodes to no APT line and no WEFAX phasing; an SSTV track of
    noise finds no VIS."""
    rng = np.random.default_rng(8)
    for n_lines in (1, 3, 8):
        img, info = apt.decode_words(rng.uniform(0, 1, n_lines * apt.LINE_WORDS))
        assert info["lines"] == 0 and img.shape == (0, apt.LINE_WORDS)
    assert apt.decode_words(np.zeros(10))[1]["lines"] == 0
    noise = rng.normal(size=int(8 * FS["wefax"])).astype(np.float32)
    img, info = wefax.decode_audio(noise, FS["wefax"], device=CPU)
    assert info["lines"] == 0 and img.shape[0] == 0
    img, info = sstv.decode_audio(noise[: int(3 * FS["sstv"])], FS["sstv"], device=CPU)
    assert info == {"mode": None, "lines": 0} and img.shape == (0, 0, 3)


def test_apt_end_to_end_inverse():
    img = apt_image(8)
    got, info = apt.decode_audio(apt.apt_modulate(img, FS["apt"]), FS["apt"], device=CPU)
    assert info["lines"] >= len(img) - 2
    s = np.asarray(info["syncs"])
    assert np.all(np.diff(s) == apt.LINE_WORDS)
    first = int(s[0]) // apt.LINE_WORDS + (1 if int(s[0]) % apt.LINE_WORDS > 39 else 0)
    va_got, _ = apt.split_channels(got)
    va_want, _ = apt.split_channels(img)
    n = min(len(va_got), len(img) - first)
    assert n >= 4
    err = np.abs(va_got[:n].astype(float) - va_want[first:first + n])
    assert np.median(err) <= 3.0 and np.quantile(err, 0.95) <= 12.0
    assert info["level_hi"] > info["level_lo"] > 0.0


@pytest.mark.parametrize("mode", ["martin1", "martin2"])
def test_sstv_end_to_end_inverse(mode):
    img = sstv_image(4)
    got, info = sstv.decode_audio(sstv.sstv_modulate(img, FS["sstv"], mode=mode), FS["sstv"],
                                  device=CPU)
    assert info["mode"] == mode and info["vis_detected"] and info["lines"] >= len(img) - 1
    n = min(len(got), len(img))
    err = np.abs(got[:n].astype(float) - img[:n])
    assert np.median(err) <= 4.0 and np.quantile(err, 0.95) <= 16.0
    # a recording cut after the header decodes with the mode given
    cut = sstv.sstv_modulate(img, FS["sstv"], mode=mode)[int(1.0 * FS["sstv"]):]
    _, info = sstv.decode_audio(cut, FS["sstv"], mode=mode, device=CPU)
    assert info["mode"] == mode and not info["vis_detected"] and info["lines"] >= 2


@pytest.mark.parametrize("lpm", [120.0, 90.0])
def test_wefax_end_to_end_inverse(lpm):
    img = wefax_chart(4)
    got, info = wefax.decode_audio(wefax.wefax_modulate(img, FS["wefax"], lpm=lpm),
                                   FS["wefax"], lpm=lpm, device=CPU)
    assert info["phasing_score"] > 0.9 and info["lines"] >= len(img) - 1
    n = min(len(got), len(img))
    err = np.abs(got[:n].astype(float) - img[:n])
    assert np.median(err) <= 4.0 and np.quantile(err, 0.95) <= 16.0


def test_receivers_refuse_bad_rates():
    for bad, fn in ((11025.0, apt.apt_receiver), (4000.0, sstv.sstv_receiver),
                    (8000.0, wefax.wefax_receiver)):
        with pytest.raises(ValueError):
            fn(bad)


def _read_pnm(path):
    raw = Path(path).read_bytes()
    magic, dims, _maxval, payload = raw.split(b"\n", 3)
    w, h = (int(v) for v in dims.split())
    return magic, (h, w), np.frombuffer(payload, np.uint8)


APPS = {
    "apt": (apt_decode.main, japt_app.main, "pgm"),
    "sstv": (sstv_decode.main, jsstv_app.main, "ppm"),
    "wefax": (wefax_decode.main, jwefax_app.main, "pgm"),
}


@pytest.fixture(scope="module")
def app_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagery_apps")
    files = {}
    a = apt.apt_modulate(apt_image(6, 2), FS["apt"])
    a.tofile(d / "apt.f32")
    phase = 2 * np.pi * 0.6 * np.cumsum(a[: len(a) // 2].astype(np.float64))
    np.exp(1j * phase).astype(np.complex64).tofile(d / "apt.cf32")
    sstv.sstv_modulate(sstv_image(3, seed=5), FS["sstv"]).tofile(d / "sstv.f32")
    wefax.wefax_modulate(wefax_chart(3, 9), FS["wefax"], phasing_lines=4).tofile(d / "wefax.f32")
    for k in ("apt.f32", "apt.cf32", "sstv.f32", "wefax.f32"):
        files[k] = str(d / k)
    return files


@pytest.mark.parametrize("case", [("apt", "apt.f32", []), ("apt", "apt.f32", ["--channel", "a"]),
                                  ("apt", "apt.f32", ["--channel", "b"]),
                                  ("apt", "apt.cf32", ["--channel", "a"]),
                                  ("sstv", "sstv.f32", []), ("wefax", "wefax.f32", [])],
                         ids=["apt", "apt_a", "apt_b", "apt_cf32", "sstv", "wefax"])
def test_app_matches_jax_app(app_inputs, tmp_path, capsys, case):
    kind, name, extra = case
    port_main, jax_main, ext = APPS[kind]
    rate = ["-s", str(FS[kind])]
    assert jax_main([app_inputs[name], *rate, "-o", str(tmp_path / f"j.{ext}"), *extra]) == 0
    jout = capsys.readouterr().out
    assert port_main([app_inputs[name], *rate, "-o", str(tmp_path / f"p.{ext}"), *extra,
                      "--device", "cpu"]) == 0
    pout = capsys.readouterr().out
    jm, jshape, jpix = _read_pnm(tmp_path / f"j.{ext}")
    pm, pshape, ppix = _read_pnm(tmp_path / f"p.{ext}")
    assert (pm, pshape) == (jm, jshape) and pshape[0] >= 2
    assert np.max(np.abs(ppix.astype(int) - jpix)) <= 1
    assert pout.split(" -> ")[0].split(",")[0] == jout.split(" -> ")[0].split(",")[0]
    if kind == "apt" and extra:
        assert pshape[1] == 909


@pytest.mark.parametrize("kind", list(APPS))
def test_app_refuses_bad_rate(app_inputs, capsys, kind):
    port_main, jax_main, _ = APPS[kind]
    path = app_inputs[f"{kind}.f32"]
    bad = {"apt": "44100", "sstv": "4000", "wefax": "8000"}[kind]
    assert jax_main([path, "-s", bad]) == 1
    jout = capsys.readouterr().out
    assert port_main([path, "-s", bad, "--device", "cpu"]) == 1
    assert capsys.readouterr().out == jout


def test_app_device_cuda_without_a_card_exits_1(app_inputs, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the app runs on it")
    assert apt_decode.main([app_inputs["apt.f32"]]) == 1
    assert "no CUDA device" in capsys.readouterr().err
