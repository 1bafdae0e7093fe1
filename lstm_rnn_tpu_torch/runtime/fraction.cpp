// Native fraction assembly: one padded mini-batch of parallel sequences.
//
// The reference assembles its fractions in C++ (currennt_lib/src/
// data_sets/DataSet.cpp:300-414); the DataSet (data/dataset.py
// `_make_fraction`) hands this file the member sequences and the padded
// shape, and gets back the arrays its NumPy path builds, byte for byte:
//
// - inputs [T, B, ctx * F] float32: frame t of row b holds frames
//   t - left .. t + right of sequence b, clamped to the sequence (the
//   edges duplicated, DataSet.cpp:302-364); zeros past the sequence;
// - targets [T, B] int32 (classification) or [T, B, O] float32
//   (regression), shifted by output_time_lag: frame t < lag of a sequence
//   holds the default, class 0 or 1.0 in every column (DataSet.cpp:
//   369-394), frame t in [lag, length) holds the target of frame t - lag;
//   past the sequence -1 (classes) or zeros;
// - pattypes [T, B] int8: 0 NONE, 1 FIRST, 2 NORMAL, 3 LAST, FIRST winning
//   for a one-frame sequence (DataSet.cpp:397-407).
//
// Rows b >= n_seqs (a short last fraction) are all padding. Input noise
// stays on the NumPy path, whose random stream this file does not draw.
//
// Counterpart of lstm_rnn_tpu/runtime/fraction.cpp, with its entry
// point's signature. That file fills every output with its padding and
// then writes the sequences over it, a column at a time; this one walks
// the outputs once in memory order and writes every byte once, so that a
// caller assembling straight into a pinned staging buffer (the Trainer's
// `_Staging`) writes each byte of it once. No static state: the function
// is reentrant, and ctypes calls it without the GIL from several threads
// at once (the DataSets' prefetch threads, the Trainer's dispatch thread).

#include <cstdint>
#include <cstring>

namespace {

constexpr int8_t PAT_NONE = 0, PAT_FIRST = 1, PAT_NORMAL = 2, PAT_LAST = 3;

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// inputs_cat: the sequences' frames concatenated, [sum(lengths), F];
// targets_cat: [sum(lengths)] int32 or [sum(lengths), O] float32;
// offsets[i]: the first frame of sequence i in them. The outputs are
// C-contiguous and the caller's; every byte of them is written.
void lrt_assemble_fraction(
    const float* inputs_cat, const void* targets_cat, const int32_t* offsets,
    const int32_t* lengths, int n_seqs, int is_classification, int T, int B,
    int F, int O, int left, int right, int lag, float* out_inputs,
    void* out_targets, int8_t* out_pattypes) {
  const int ctx = left + right + 1;
  const long frame = (long)ctx * F;  // floats of one spliced frame
  const int32_t* classes = (const int32_t*)targets_cat;
  const float* patterns = (const float*)targets_cat;
  int32_t* out_classes = (int32_t*)out_targets;
  float* out_patterns = (float*)out_targets;
  for (int t = 0; t < T; ++t) {
    for (int b = 0; b < B; ++b) {
      const long tb = (long)t * B + b;
      const int len = b < n_seqs ? lengths[b] : 0;
      float* in = out_inputs + tb * frame;
      if (t >= len) {
        std::memset(in, 0, sizeof(float) * frame);
        out_pattypes[tb] = PAT_NONE;
        if (is_classification)
          out_classes[tb] = -1;
        else
          std::memset(out_patterns + tb * O, 0, sizeof(float) * O);
        continue;
      }
      const long first = offsets[b];
      const float* src = inputs_cat + first * F;
      for (int k = 0; k < ctx; ++k) {
        const int ts = clampi(t + k - left, 0, len - 1);
        std::memcpy(in + (long)k * F, src + (long)ts * F, sizeof(float) * F);
      }
      out_pattypes[tb] = t == 0 ? PAT_FIRST
                                : (t == len - 1 ? PAT_LAST : PAT_NORMAL);
      if (is_classification) {
        out_classes[tb] = t >= lag ? classes[first + t - lag] : 0;
      } else if (t >= lag) {
        std::memcpy(out_patterns + tb * O, patterns + (first + t - lag) * O,
                    sizeof(float) * O);
      } else {
        for (int j = 0; j < O; ++j) out_patterns[tb * O + j] = 1.0f;
      }
    }
  }
}

}  // extern "C"
