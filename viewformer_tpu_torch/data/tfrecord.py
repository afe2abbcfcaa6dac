"""TFRecord container and tf.train.Example codec, in pure Python (the port's
own copy of viewformer_tpu/data/tfrecord.py, without its native fast paths).

The bytes are the JAX package's and the reference's: a shard is a sequence
of framed records, each an `Example` protobuf with the features
  'cameras' -> float list, flat [N*7] (or legacy 'cameras-gqn' [N*5])
  'codes'   -> int64 list, flat [N*token_image_size**2]
  'frames'  -> bytes list (encoded images)

Framing: u64le length | u32le masked-crc32c(length) | payload |
u32le masked-crc32c(payload). The `.index` sidecar of a shard lists
"offset length" per record.
"""
import struct

import numpy as np

_CRC_TABLE = None


def _crc32c(data):
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in bytes(data):
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire primitives
# ---------------------------------------------------------------------------

def _write_varint(out, value):
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field_number, wire_type):
    return (field_number << 3) | wire_type


def _encode_len_delimited(out, field_number, payload):
    _write_varint(out, _tag(field_number, 2))
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_bytes_list(values):
    out = bytearray()
    for v in values:
        _encode_len_delimited(out, 1, v)
    return bytes(out)


def _encode_float_list(values):
    payload = np.asarray(values, np.float32).tobytes()
    out = bytearray()
    _encode_len_delimited(out, 1, payload)  # packed
    return bytes(out)


def _encode_int64_list(values):
    payload = bytearray()
    for v in np.asarray(values, np.int64).reshape(-1).tolist():
        _write_varint(payload, v & 0xFFFFFFFFFFFFFFFF)  # two's complement for negatives
    out = bytearray()
    _encode_len_delimited(out, 1, bytes(payload))  # packed
    return bytes(out)


_BYTES_LIST, _FLOAT_LIST, _INT64_LIST = 1, 2, 3


def encode_example(features):
    """features: dict name -> (kind, value) where kind in
    {'bytes': list[bytes], 'float': array, 'int64': array}."""
    features_msg = bytearray()
    for name, (kind, value) in features.items():
        if kind == 'bytes':
            inner = _encode_bytes_list(value)
            field = _BYTES_LIST
        elif kind == 'float':
            inner = _encode_float_list(value)
            field = _FLOAT_LIST
        elif kind == 'int64':
            inner = _encode_int64_list(value)
            field = _INT64_LIST
        else:
            raise ValueError(f'Unknown feature kind: {kind}')
        feature_msg = bytearray()
        _encode_len_delimited(feature_msg, field, inner)
        entry = bytearray()
        _encode_len_delimited(entry, 1, name.encode('utf-8'))
        _encode_len_delimited(entry, 2, bytes(feature_msg))
        _encode_len_delimited(features_msg, 1, bytes(entry))
    example = bytearray()
    _encode_len_delimited(example, 1, bytes(features_msg))
    return bytes(example)


def _iter_fields(buf, start, end):
    pos = start
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            length, pos = _read_varint(buf, pos)
            yield field, wire, pos, pos + length
            pos += length
        elif wire == 0:
            vstart = pos
            _, pos = _read_varint(buf, pos)
            yield field, wire, vstart, pos
        elif wire == 5:
            yield field, wire, pos, pos + 4
            pos += 4
        elif wire == 1:
            yield field, wire, pos, pos + 8
            pos += 8
        else:
            raise ValueError(f'Unsupported wire type {wire}')


def _decode_feature(buf, start, end):
    for field, wire, s, e in _iter_fields(buf, start, end):
        if field == _BYTES_LIST:
            values = []
            for f2, w2, s2, e2 in _iter_fields(buf, s, e):
                if f2 == 1 and w2 == 2:
                    values.append(bytes(buf[s2:e2]))
            return values
        if field == _FLOAT_LIST:
            chunks = []
            for f2, w2, s2, e2 in _iter_fields(buf, s, e):
                if f2 != 1:
                    continue
                if w2 == 2:  # packed
                    chunks.append(np.frombuffer(buf, np.dtype('<f4'), count=(e2 - s2) // 4, offset=s2))
                elif w2 == 5:  # unpacked single
                    chunks.append(np.frombuffer(buf, np.dtype('<f4'), count=1, offset=s2))
            return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)
        if field == _INT64_LIST:
            values = []
            for f2, w2, s2, e2 in _iter_fields(buf, s, e):
                if f2 != 1:
                    continue
                if w2 == 2:  # packed
                    pos = s2
                    while pos < e2:
                        v, pos = _read_varint(buf, pos)
                        values.append(v)
                elif w2 == 0:
                    v, _ = _read_varint(buf, s2)
                    values.append(v)
            return np.array(values, np.uint64).astype(np.int64)
    return None


def decode_example(payload):
    """Example bytes -> dict name -> list[bytes] | np.float32[...] | np.int64[...]."""
    buf = memoryview(payload)
    out = {}
    for field, wire, s, e in _iter_fields(buf, 0, len(buf)):
        if field != 1 or wire != 2:
            continue
        # Features message: map entries
        for f2, w2, s2, e2 in _iter_fields(buf, s, e):
            if f2 != 1 or w2 != 2:
                continue
            key = None
            value = None
            for f3, w3, s3, e3 in _iter_fields(buf, s2, e2):
                if f3 == 1 and w3 == 2:
                    key = bytes(buf[s3:e3]).decode('utf-8')
                elif f3 == 2 and w3 == 2:
                    value = _decode_feature(buf, s3, e3)
            if key is not None:
                out[key] = value
    return out


# ---------------------------------------------------------------------------
# TFRecord container
# ---------------------------------------------------------------------------

class RecordWriter:
    def __init__(self, path):
        self._file = open(path, 'wb')

    def write(self, payload):
        header = struct.pack('<Q', len(payload))
        self._file.write(header)
        self._file.write(struct.pack('<I', _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack('<I', _masked_crc(payload)))

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def read_records(path, verify_crc=False):
    """Yield raw record payloads from a .tfrecord file."""
    with open(path, 'rb') as f:
        while True:
            header = f.read(8)
            if len(header) == 0:
                return
            if len(header) < 8:
                raise IOError(f'Truncated record header in {path}')
            (length,) = struct.unpack('<Q', header)
            (length_crc,) = struct.unpack('<I', f.read(4))
            if verify_crc and _masked_crc(header) != length_crc:
                raise IOError(f'Corrupted record length crc in {path}')
            payload = f.read(length)
            if len(payload) < length:
                raise IOError(f'Truncated record payload in {path}')
            (payload_crc,) = struct.unpack('<I', f.read(4))
            if verify_crc and _masked_crc(payload) != payload_crc:
                raise IOError(f'Corrupted record payload crc in {path}')
            yield payload


def read_record_spans(path):
    """Walk the TFRecord framing without decoding; yields (offset,
    total_length) per record, the format of the `.index` sidecar."""
    with open(path, 'rb') as f:
        while True:
            offset = f.tell()
            header = f.read(8)
            if len(header) == 0:
                return
            (length,) = struct.unpack('<Q', header)
            f.seek(4 + length + 4, 1)
            yield offset, f.tell() - offset


def build_shard_index(tfrecord_file, index_file):
    """Write the per-shard byte-offset `.index` sidecar."""
    with open(index_file, 'w') as out:
        for offset, length in read_record_spans(tfrecord_file):
            out.write(f'{offset} {length}\n')
