"""Native C++ WAV codec + streaming block reader tests."""

import numpy as np
import pytest
import scipy.io.wavfile

import zaftpu
from zaftpu.io.stream import BlockReader
from zaftpu.io.wav import wavread_f32


@pytest.fixture(scope="module")
def native_lib():
    from zaftpu.io import native

    lib = native.load()
    if lib is None:
        pytest.skip("native codec unavailable (no g++)")
    return native


@pytest.fixture()
def i16_file(tmp_path):
    rng = np.random.default_rng(3)
    data = (rng.uniform(-0.8, 0.8, (44100, 2)) * 32767).astype(np.int16)
    path = tmp_path / "x.wav"
    scipy.io.wavfile.write(path, 44100, data)
    return str(path), data


def test_info_and_full_read_matches_scipy(native_lib, i16_file):
    path, data = i16_file
    handle = native_lib.WavFile(path)
    assert (handle.sample_rate, handle.channels, handle.bits,
            handle.frames) == (44100, 2, 16, 44100)
    out = handle.read()
    np.testing.assert_allclose(out, data.astype(np.float32) / 32768.0,
                               atol=1e-7)


def test_seek_read(native_lib, i16_file):
    path, data = i16_file
    handle = native_lib.WavFile(path)
    out = handle.read(1000, 256)
    np.testing.assert_allclose(out, data[1000:1256] / 32768.0, atol=1e-7)


def test_read_past_end_clips(native_lib, i16_file):
    path, data = i16_file
    handle = native_lib.WavFile(path)
    out = handle.read(44000, 500)
    assert out.shape == (100, 2)


def test_float32_roundtrip(native_lib, tmp_path):
    rng = np.random.default_rng(4)
    data = rng.uniform(-1, 1, (5000, 2)).astype(np.float32)
    path = str(tmp_path / "f.wav")
    native_lib.write_f32(path, 22050, data)
    handle = native_lib.WavFile(path)
    assert handle.format == 3 and handle.bits == 32
    np.testing.assert_array_equal(handle.read(), data)
    # scipy reads it back identically (interop check)
    sr, back = scipy.io.wavfile.read(path)
    assert sr == 22050
    np.testing.assert_array_equal(back, data)


def test_i16_write_interop(native_lib, tmp_path):
    data = (np.linspace(-1, 1, 1000) * 32000).astype(np.int16)
    path = str(tmp_path / "i.wav")
    native_lib.write_i16(path, 8000, data)
    sr, back = scipy.io.wavfile.read(path)
    assert sr == 8000
    np.testing.assert_array_equal(back, data)


def test_24bit_decode(native_lib, tmp_path):
    """Hand-build a 24-bit PCM file; scipy can read 24-bit for comparison."""
    rng = np.random.default_rng(5)
    vals = rng.integers(-2 ** 23, 2 ** 23 - 1, 2048, dtype=np.int32)
    raw = np.zeros((2048, 3), dtype=np.uint8)
    raw[:, 0] = vals & 0xFF
    raw[:, 1] = (vals >> 8) & 0xFF
    raw[:, 2] = (vals >> 16) & 0xFF
    path = str(tmp_path / "b24.wav")
    import struct

    data_bytes = raw.tobytes()
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(data_bytes)) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 44100,
                                       44100 * 3, 3, 24))
        fh.write(b"data" + struct.pack("<I", len(data_bytes)) + data_bytes)
    handle = native_lib.WavFile(path)
    out = handle.read()[:, 0]
    np.testing.assert_allclose(out, vals / 8388608.0, atol=1e-7)


def test_wavread_f32_matches_wavread(i16_file):
    path, _ = i16_file
    f64, sr64 = zaftpu.wavread(path)
    f32, sr32 = wavread_f32(path)
    assert sr64 == sr32
    np.testing.assert_allclose(f32, f64, atol=1e-7)


def test_block_reader_seamless_stft(i16_file):
    """Per-block STFTs with window-overlap carry concatenate to the
    whole-signal STFT — the streaming analog of the sharded halo geometry."""
    path, _ = i16_file
    wl, step = 512, 256
    full, sr = zaftpu.wavread(path)
    mono = full.mean(axis=1).astype(np.float32)

    from zaftpu.core.windows import hamming
    from zaftpu.transforms.stft import _stft_frames_half
    import jax.numpy as jnp

    win = jnp.asarray(hamming(wl).astype(np.float32))
    block = 32 * step
    reader = BlockReader(path, block_samples=block, overlap=wl - step)

    # Whole-signal frames (no centering pad — raw frame grid for this test).
    t_total = (len(mono) - (wl - step)) // step
    whole = np.asarray(_stft_frames_half(
        jnp.asarray(np.concatenate([mono, np.zeros(wl, np.float32)])),
        win, step))

    pieces = []
    for start, blk in reader:
        t_local = block // step
        frames = np.asarray(_stft_frames_half(jnp.asarray(blk), win, step))
        # Drop the frames that came from the block's centering pad: keep the
        # grid-aligned interior [pad-frames ...]. For this seamlessness test
        # compare raw frame grids instead: recompute without centering.
        pieces.append((start, frames))

    # Frame j of the whole signal starts at j*step - wl//2 (centering);
    # block-local frame j' starts at start + j'*step - wl//2. Frames whose
    # support lies fully inside the block (incl. overlap) must match.
    for start, frames in pieces[:3]:
        j0 = start // step
        inner = range(2, t_local - 2)
        for j in inner:
            if j0 + j >= whole.shape[0]:
                break
            np.testing.assert_allclose(frames[j], whole[j0 + j], atol=1e-4)


def test_block_reader_fallback_matches_native(i16_file, monkeypatch):
    path, _ = i16_file
    a = BlockReader(path, 4096, overlap=128)
    import zaftpu.io.stream as stream_mod

    class _Boom:
        def __init__(self, *_):
            raise RuntimeError("forced fallback")

    monkeypatch.setattr("zaftpu.io.native.WavFile", _Boom)
    b = BlockReader(path, 4096, overlap=128)
    assert b._native is None
    for i in (0, 3, a.num_blocks - 1):
        np.testing.assert_allclose(a.read_block(i), b.read_block(i),
                                   atol=1e-7)


def test_malformed_zero_channel_header(native_lib, tmp_path):
    """A fmt chunk with channels=0/bits=0 must return an error code, not
    SIGFPE the process (read_block once lacked wav_info's
    validation)."""
    import ctypes
    import struct

    path = tmp_path / "bad.wav"
    # RIFF/WAVE with fmt declaring 0 channels / 0 bits and a data chunk.
    fmt = struct.pack("<HHIIHH", 1, 0, 44100, 0, 0, 0)
    data = b"\x00" * 64
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    blob = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body
    path.write_bytes(blob)

    out = np.empty(64, np.float32)
    rc = native_lib.load().zaftpu_wav_read_block(
        str(path).encode(), 0, 16,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    assert rc < 0
    with pytest.raises(ValueError):
        native_lib.WavFile(str(path))
