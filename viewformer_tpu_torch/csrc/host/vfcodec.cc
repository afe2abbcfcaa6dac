// Native decode of packed int64 varint lists (the code tokens of a
// generate-codes dataset) for the host reader: the port's own copy of the
// varint decode of native/vfcodec.cc, built and bound with ctypes by
// viewformer_tpu_torch/data/native.py for viewformer_tpu_torch/data/tfrecord.py.
//
// Build (data/native.py does): g++ -O3 -shared -fPIC -o libvfcodec.so vfcodec.cc

#include <cstddef>
#include <cstdint>

extern "C" {

// Decode a packed repeated-int64 varint buffer. Returns the number of values
// decoded, or -1 on overflow/overrun.
int64_t vf_decode_varints(const uint8_t* buf, size_t n, int64_t* out,
                          int64_t max_out) {
  size_t pos = 0;
  int64_t count = 0;
  while (pos < n) {
    if (count >= max_out) return -1;
    uint64_t result = 0;
    int shift = 0;
    while (true) {
      if (pos >= n || shift > 63) return -1;
      uint8_t byte = buf[pos++];
      result |= static_cast<uint64_t>(byte & 0x7F) << shift;
      if (!(byte & 0x80)) break;
      shift += 7;
    }
    out[count++] = static_cast<int64_t>(result);
  }
  return count;
}

}  // extern "C"
