"""The port's native host codec (viewformer_tpu_torch/data/native.py, built
from viewformer_tpu_torch/csrc/host/vfcodec.cc): the packed int64 varint
decode against the JAX package's library (viewformer_tpu.data.native,
built from native/) and the pure-Python path, the int64 feature decode of
data/tfrecord.py going through it, its fallback without the library, and
its build (one library a hash of the source)."""
import os
import shutil

import numpy as np
import pytest

from viewformer_tpu.data import native as jnative
from viewformer_tpu.data import tfrecord as jtfrecord
from viewformer_tpu_torch.data import native, tfrecord


@pytest.fixture(scope='module')
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip('native codec unavailable (no compiler)')
    return lib


def _packed(values):
    payload = bytearray()
    for v in values.tolist():
        tfrecord._write_varint(payload, v & 0xFFFFFFFFFFFFFFFF)
    return bytes(payload)


def _python_varints(payload):
    """The pure-Python decode of data/tfrecord.py, the plain version."""
    values, pos = [], 0
    while pos < len(payload):
        v, pos = tfrecord._read_varint(payload, pos)
        values.append(v)
    return np.array(values, np.uint64).astype(np.int64)


def test_decode_varints_parity(lib):
    values = np.array([0, 1, 127, 128, 16383, 16384, 2 ** 40, -1, -2 ** 40], np.int64)
    payload = _packed(values)
    decoded = native.decode_varints(payload)
    np.testing.assert_array_equal(decoded, values)
    np.testing.assert_array_equal(decoded, jnative.decode_varints(payload))
    with pytest.raises(IOError):
        native.decode_varints(payload[:-1])  # the last varint cut


VARINT_CASES = {
    'empty': np.zeros((0,), np.int64),
    'one-zero': np.zeros((1,), np.int64),
    'int64-extremes': np.array([2 ** 63 - 1, -2 ** 63, -1], np.int64),
    'codes': np.random.RandomState(0).randint(0, 1024, 6400).astype(np.int64),
    'wide': np.random.RandomState(1).randint(-2 ** 62, 2 ** 62, 500, dtype=np.int64),
}


@pytest.mark.parametrize('case', list(VARINT_CASES))
def test_decode_varints_matches_python_and_jax(lib, case):
    """Empty, one zero, the int64 extremes (10-byte varints), a record of
    6400 codes below 1024 and wide signed values: equal to the pure-Python
    decode and to the JAX package's library."""
    values = VARINT_CASES[case]
    payload = _packed(values)
    decoded = native.decode_varints(payload)
    assert decoded.dtype == np.int64
    np.testing.assert_array_equal(decoded, values)
    np.testing.assert_array_equal(decoded, _python_varints(payload))
    np.testing.assert_array_equal(decoded, jnative.decode_varints(payload))


def test_decode_varints_refuses_an_overlong_varint(lib):
    """Eleven continuation bytes shift past 63 bits: an IOError, as the
    JAX package's library refuses it."""
    payload = b'\xff' * 10 + b'\x01'
    with pytest.raises(IOError):
        native.decode_varints(payload)
    with pytest.raises(IOError):
        jnative.decode_varints(payload)


def test_example_int64_decode_uses_native(lib, monkeypatch):
    codes = np.random.RandomState(0).randint(0, 1024, 1280).astype(np.int64)
    payload = tfrecord.encode_example({'codes': ('int64', codes)})
    assert payload == jtfrecord.encode_example({'codes': ('int64', codes)})
    calls = []
    decode = native.decode_varints
    monkeypatch.setattr(native, 'decode_varints', lambda b: calls.append(1) or decode(b))
    out = tfrecord.decode_example(payload)
    assert calls == [1]
    np.testing.assert_array_equal(out['codes'], codes)
    np.testing.assert_array_equal(out['codes'], jtfrecord.decode_example(payload)['codes'])
    # the pure-Python path, as without the library
    monkeypatch.setattr(native, 'decode_varints', lambda b: None)
    np.testing.assert_array_equal(tfrecord.decode_example(payload)['codes'], codes)


def test_without_the_library_the_reader_falls_back(tmp_path, monkeypatch, capsys):
    """A library that does not build: one stderr line says why,
    decode_varints returns None and decode_example takes the pure-Python
    path, with the same values."""
    monkeypatch.setattr(native, '_HOST_DIR', str(tmp_path))  # no source there
    monkeypatch.setattr(native, '_BUILD_DIR', str(tmp_path / 'build'))
    native.get_lib.cache_clear()
    try:
        assert native.decode_varints(_packed(np.arange(5))) is None
        assert 'native codec unavailable' in capsys.readouterr().err
        codes = np.arange(-3, 300, dtype=np.int64)
        payload = tfrecord.encode_example({'codes': ('int64', codes)})
        np.testing.assert_array_equal(tfrecord.decode_example(payload)['codes'], codes)
    finally:
        native.get_lib.cache_clear()


def test_build_is_keyed_by_the_source_hash(lib, tmp_path, monkeypatch):
    """A second build of the same source reuses the library; an edited
    source builds a library of another name."""
    host = tmp_path / 'host'
    host.mkdir()
    shutil.copy(os.path.join(native._HOST_DIR, 'vfcodec.cc'), host / 'vfcodec.cc')
    monkeypatch.setattr(native, '_HOST_DIR', str(host))
    monkeypatch.setattr(native, '_BUILD_DIR', str(tmp_path / 'build'))
    first = native.build()
    mtime = os.path.getmtime(first)
    assert native.build() == first and os.path.getmtime(first) == mtime
    with open(host / 'vfcodec.cc', 'a') as f:
        f.write('\n// edited\n')
    second = native.build()
    assert second != first and os.path.exists(second)
    assert sorted(os.listdir(tmp_path / 'build')) == sorted(
        os.path.basename(p) for p in (first, second))
