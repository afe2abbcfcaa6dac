"""The native host codec, built with g++ and bound with ctypes (the port's
own copy of the varint decode of viewformer_tpu/data/native.py):

  csrc/host/vfcodec.cc  decode_varints (packed int64 lists: code tokens)

It runs on the host, not the card. The library is built on first use,
`g++ -O3 -shared -fPIC`, into csrc/build/, under a name that carries the
hash of its source, so an edited source is rebuilt. When it cannot be built
or loaded, one line on stderr says why and decode_varints returns None: its
caller (data/tfrecord.py) then takes the pure-Python path, which stays the
plain version the native one is held against.
"""
import ctypes
import functools
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_HOST_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         'csrc', 'host')
_BUILD_DIR = os.path.join(os.path.dirname(_HOST_DIR), 'build')
_P64 = ctypes.POINTER(ctypes.c_int64)
_build_lock = threading.Lock()  # reader threads may all ask for the library at once


def build(name='vfcodec'):
    """Compile csrc/host/<name>.cc into csrc/build/lib<name>-<hash>.so,
    once per hash of the source; returns the library's path. Raises
    RuntimeError with g++'s output when it fails (OSError without g++)."""
    source = os.path.join(_HOST_DIR, f'{name}.cc')
    with open(source, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f'lib{name}-{digest}.so')
    with _build_lock:
        if os.path.exists(path):
            return path
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f'{path}.{os.getpid()}.tmp'  # other processes may build it too
        proc = subprocess.run(['g++', '-O3', '-shared', '-fPIC', '-o', tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ exited {proc.returncode}: {proc.stderr.strip()[-2000:]}')
        os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=1)
def get_lib():
    """The codec library (built on first use), or None."""
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError) as e:
        print(f'viewformer_tpu_torch: native codec unavailable ({e}); using pure-python '
              'fallback', file=sys.stderr)
        return None
    lib.vf_decode_varints.restype = ctypes.c_int64
    lib.vf_decode_varints.argtypes = [ctypes.c_char_p, ctypes.c_size_t, _P64, ctypes.c_int64]
    return lib


def decode_varints(buffer):
    """A packed int64 varint list -> np.int64 array, or None without the
    library. Raises IOError on an overrun."""
    lib = get_lib()
    if lib is None:
        return None
    max_out = max(len(buffer), 1)
    out = np.zeros(max_out, np.int64)
    count = lib.vf_decode_varints(bytes(buffer), len(buffer), out.ctypes.data_as(_P64), max_out)
    if count < 0:
        raise IOError('Corrupt varint buffer')
    return out[:count].copy()
