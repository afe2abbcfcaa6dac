#!/usr/bin/env python3
"""Builds the forward kernels of csrc/attention_fwd_sm90.cu as committed and in
two alternative designs of the dropout kernels B5 and B7, on one CUDA
device, and prints one JSON line.

    python3 viewformer_tpu_torch/tools/fwd_variants.py [--parent DIR] [--n 20]

The alternatives, each a text substitution into a copy of the source:
  one_cta_an_sm   the kDrop instantiations at one CTA an SM (__launch_bounds__
                  minBlocks 1: up to 168 registers a thread, not 96);
  hash_during_s   each thread hashes its 32 keep tests of a frame while the
                  frame's S = Q K^T is in flight, into a 32-bit mask that the
                  pack of P reads (the committed kernel hashes at the pack).
For each build: the registers and spills ptxas reports for each kernel; B5
and B7 at the training shapes (B=64, H=12, T=20, S=2 branches, rate 0.1)
and at T=1 and 19 against their plain twins; B5's and B7's dropout masks at
T=19 (B7 with S=1 and 2) bit for bit (chip_smoke.py's probes); and the
CUDA-event times of B1, B2, B5 and B7 at the training shapes (chip_smoke.py's
time_ms), the builds timed in turns (a, b, c, c, b, a). With --parent, the
SASS of every kernel of the committed sources is also compared, instruction
by instruction, with that of the checkout DIR (B1/B2 and the backward
kernels should be unchanged by a change to B5/B7 alone).
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(ROOT, 'viewformer_tpu_torch', 'csrc')
BUILD = os.path.join(CSRC, 'build', 'variants')
NVCC = ['/usr/local/cuda/bin/nvcc', '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
        '-O3']
FORWARD = ('block_causal_attention_fwd', 'branch_attention_fwd',
           'block_causal_attention_dropout_fwd', 'branch_attention_dropout_fwd')
VARIANTS = {
    'committed': [],
    'one_cta_an_sm': [('NC == 1 ? 3 : 2', 'NC == 1 ? 3 : (kDrop ? 1 : 2)')],
    'hash_during_s': [
        ('  wgmma_commit();\n  wgmma_wait_all();\n  fence_regs(s);\n',
         '  wgmma_commit();\n  uint32_t kept = 0;\n  if (kDrop) {\n#pragma unroll\n'
         '    for (int i = 0; i < 32; ++i)\n'
         '      kept |= (uint32_t)keep_test(keep, h0, kPrime1, keep.stride1, i) << i;\n'
         '    asm volatile("" : "+r"(kept));\n  }\n  wgmma_wait_all();\n  fence_regs(s);\n'),
        ('keep_test(keep, h0, kPrime1, keep.stride1, 2 * i) ?', '(kept >> (2 * i)) & 1u ?'),
        ('keep_test(keep, h0, kPrime1, keep.stride1, 2 * i + 1) ?',
         '(kept >> (2 * i + 1)) & 1u ?')],
}


def build(name, substitutions):
    """The variant's source beside the headers, compiled into a shared
    library; returns (library path, ptxas lines of registers and spills)."""
    with open(os.path.join(CSRC, 'attention_fwd_sm90.cu')) as f:
        text = f.read()
    for old, new in substitutions:
        if text.count(old) != 1:
            raise RuntimeError(f'{name}: the source no longer has {old!r} once')
        text = text.replace(old, new)
    src = os.path.join(BUILD, f'{name}.cu')
    with open(src, 'w') as f:
        f.write(text)
    lib = os.path.join(BUILD, f'lib{name}.so')
    log = subprocess.run(NVCC + ['-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-I', CSRC,
                                 '-o', lib, src], capture_output=True, text=True, check=True)
    lines = [line.strip() for line in log.stdout.splitlines() + log.stderr.splitlines()
             if 'Compiling entry' in line or 'Used' in line or 'spill' in line]
    return lib, lines


def sass(root, source, label):
    """{kernel name: [instruction]} of one source of a checkout."""
    cubin = os.path.join(BUILD, f'{label}_{source}.cubin')
    subprocess.run(NVCC + ['-cubin', '-o', cubin,
                           os.path.join(root, 'viewformer_tpu_torch', 'csrc', source)], check=True)
    text = subprocess.run(['/usr/local/cuda/bin/cuobjdump', '-sass', cubin], capture_output=True,
                          text=True, check=True).stdout
    kernels = {}
    for chunk in re.split(r'\n\s*Function : ', text)[1:]:
        lines = chunk.splitlines()
        # the anonymous namespace's hash differs between trees; the kDrop =
        # false instantiations had no kDrop argument before it existed
        name = re.sub(r'_GLOBAL__N__\w+?_cu_\w{8}', '', lines[0].strip())
        name = name.replace('ELb0EEEv', 'EEEv')
        kernels[name] = [re.sub(r'/\*[0-9a-f]{4}\*/', '', line).split(';')[0].strip()
                         for line in lines if re.match(r'\s*/\*[0-9a-f]{4}\*/', line)]
    return kernels


def sass_against(parent):
    result = {}
    for source in ('attention_fwd_sm90.cu', 'attention_bwd_sm90.cu'):
        ours, theirs = sass(ROOT, source, 'this'), sass(os.path.abspath(parent), source, 'parent')
        for name in sorted(set(ours) & set(theirs)):
            result[name] = 'identical' if ours[name] == theirs[name] else \
                f'differs ({len(theirs[name])} -> {len(ours[name])} instructions)'
        for name in sorted(set(ours) - set(theirs)):
            result[name] = 'new'
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', help='a checkout to compare the SASS with')
    parser.add_argument('--n', type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('fwd_variants: no CUDA device')
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from viewformer_tpu_torch.ops import attention_cuda as ac

    os.makedirs(BUILD, exist_ok=True)
    record = {'card': subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                                      '--format=csv,noheader'], capture_output=True, text=True,
                                     check=True).stdout.strip()}
    functions = {}
    for name, substitutions in VARIANTS.items():
        lib, record[f'{name} ptxas'] = build(name, substitutions)
        handle = ctypes.CDLL(lib)
        functions[name] = {}
        for entry in FORWARD:
            fn = getattr(handle, entry)
            fn.argtypes, fn.restype = ac._SIGNATURES[entry], ctypes.c_int
            functions[name][entry] = fn

    gen = torch.Generator(device='cuda').manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(torch.bfloat16)

    L, BH, T = 64, cs.TRAIN_B * 12, 20
    q, k, v = (rand(BH, T * L, 64) for _ in range(3))
    qb, kb, vb = (rand(2 * BH, T * L, 64) for _ in range(3))
    drop = (L, cs.WORDS, cs.RATE)
    cases = {
        'B1': (ac.block_causal_attention_fwd, ac.block_causal_attention_plain, (q, k, v), (L,)),
        'B2': (ac.branch_attention_fwd, ac.branch_attention_plain, (qb, k, v, kb, vb), (L, 0, T)),
        'B5': (ac.block_causal_attention_dropout_fwd, ac.block_causal_attention_dropout_plain,
               (q, k, v), drop),
        'B7': (ac.branch_attention_dropout_fwd, ac.branch_attention_dropout_plain,
               (qb, k, v, kb, vb), drop),
    }
    for name, fns in functions.items():
        ac._functions = fns  # the wrappers launch this build's kernels
        errors = {case: cs.forward_errors(fn, plain, tensors, extra)[2]['rel_err']
                  for case, (fn, plain, tensors, extra) in cases.items()}
        for frames in (1, 19):
            errors[f'B5 T={frames}'] = cs.forward_errors(
                ac.block_causal_attention_dropout_fwd, ac.block_causal_attention_dropout_plain,
                [rand(24, frames * L, 64) for _ in range(3)], drop)[2]['rel_err']
            for branches in (1, 2):
                operands = (rand(branches * 24, frames * L, 64), rand(24, frames * L, 64),
                            rand(24, frames * L, 64), rand(branches * 24, frames * L, 64),
                            rand(branches * 24, frames * L, 64))
                errors[f'B7 T={frames} S={branches}'] = cs.forward_errors(
                    ac.branch_attention_dropout_fwd, ac.branch_attention_dropout_plain, operands,
                    drop)[2]['rel_err']
        record[f'{name} max rel_err'] = max(errors.values())
        record[f'{name} mismatched mask bits'] = (
            cs.block_causal_fwd_probe(ac, 24, 19)[1] + sum(cs.branch_fwd_probe(ac, 24, 19, 1)[2:])
            + sum(cs.branch_fwd_probe(ac, 24, 19, 2)[2:]))
        torch.cuda.empty_cache()
    order = list(functions) + list(functions)[::-1]
    for name in order:
        ac._functions = functions[name]
        for case, (fn, _, tensors, extra) in cases.items():
            record.setdefault(f'{name} {case} ms', []).append(
                cs.time_ms(lambda: fn(*tensors, *extra, return_lse=True), args.n))
    if args.parent:
        record['sass against parent'] = sass_against(args.parent)
    print(json.dumps(record), flush=True)


if __name__ == '__main__':
    main()
