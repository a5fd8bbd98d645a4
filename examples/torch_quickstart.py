"""Quickstart on the PyTorch/CUDA port (counterpart of
``examples/quickstart.py``): the paper's pipeline end to end.

1. binarise a 3x3 conv kernel -> 9-bit bit sequences (paper Fig. 2)
2. analyse sequence frequencies (Table II)
3. Hamming-1 clustering + simplified 4-node Huffman coding (Table V)
4. run the conv with weights decoded INSIDE the fused kernel and check it
   against the uncompressed path.

On the card (the default) step 4 runs the hand-written fused
decode-contraction kernel; ``--device cpu`` runs its plain version.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bitpack, compression, frequency
from repro_torch.kernels import ops, ref


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernel) or cpu (its plain "
                         "PyTorch version)")
    device = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- a "trained-looking" binary kernel: skewed sequence distribution --
    hist = frequency.synthetic_histogram((0.46, 0.24, 0.23, 0.05), 64 * 64,
                                         rng)
    seqs = np.repeat(np.arange(512), hist)[: 64 * 64]
    rng.shuffle(seqs)
    w_bits = bitpack.sequences_to_kernel(
        seqs.reshape(64, 64).astype(np.uint16))
    print(f"kernel: Cout=64 Cin=64 3x3  ({w_bits.size} binary weights)")

    # --- frequency analysis (paper Table II) ------------------------------
    h = frequency.sequence_histogram(bitpack.kernel_to_sequences(w_bits))
    print(f"top-16 share {frequency.top_k_share(h, 16):.1%}   "
          f"top-64 {frequency.top_k_share(h, 64):.1%}   "
          f"top-256 {frequency.top_k_share(h, 256):.1%}")

    # --- compression (paper Table V) --------------------------------------
    ct_enc = compression.compress_conv3x3(w_bits, cluster=False)
    ct_cl = compression.compress_conv3x3(w_bits, cluster=True)
    print(f"compression ratio: encoding {ct_enc.ratio_stream():.3f}x, "
          f"+clustering {ct_cl.ratio_stream():.3f}x "
          f"(paper: 1.18-1.25 / 1.30-1.36)")

    # --- fused decode + xnor/popcount conv --------------------------------
    x = torch.from_numpy(
        rng.standard_normal((2, 8, 8, 64)).astype(np.float32)).to(device)
    words, tables, meta = ops.prepare_compressed_conv(w_bits, cluster=False,
                                                      device=device)
    y_compressed = ops.compressed_binary_conv3x3(
        x, words, tables, cin=64, cout=64, codes=meta["codes"])
    # the plain BNN conv, on the CPU (exact integers, whatever the device)
    y_reference = ref.binary_conv3x3(
        x.cpu(), torch.from_numpy(w_bits.astype(np.float32) * 2 - 1))
    if not torch.equal(y_compressed.cpu(), y_reference):
        raise AssertionError("fused decode+conv differs from the reference "
                             "BNN conv")
    print(f"fused decode+conv kernel == reference BNN conv  [OK] "
          f"({device.type})")
    print(f"storage (stream layout): {ct_cl.ratio_stream():.3f}x fewer "
          f"bits; kernel weight-stream (tiled, C={meta['codes']}): "
          f"{meta['ratio_tiled']:.3f}x — small Cout kernels don't amortise "
          "per-tile padding")


if __name__ == "__main__":
    main()
