"""The dynamic shared memory a block of each flash kernel asks for, as
``distkeras_tpu_torch/csrc/flash_attn.cu`` computes it for the launch
(``fwd_smem``, ``dq_smem``, ``dkv_smem``), written out again for the
tests: ``tests/test_torch_flash.py`` holds it to the 227 KB a block may
have on the CPU, and ``tests/test_torch_cuda.py`` holds it to what the
built library reports (``flash_attention.shared_bytes``), so that this
copy cannot drift from the kernels unnoticed. Imports torch and the port
only (the card's machine has no JAX)."""

from distkeras_tpu_torch.ops.kernels.flash_attention import (
    BLOCK, padded_head_dim)

#: the dynamic shared memory a block may have on the H100 (227 KB).
SMEM_LIMIT = 227 * 1024


def ring_stages(kernel: str, D: int) -> int:
    """The depth of a kernel's load ring: 3, but 2 for the forward's and
    dQ's K/V ring at the 256-wide tile, where dQ's Q and dO tiles and
    three K/V stages would pass SMEM_LIMIT."""
    return 2 if kernel != "dkv" and padded_head_dim(D) == 256 else 3


def shared_bytes(kernel: str, D: int) -> int:
    """1024 bytes of alignment slack, the tiles a block keeps (the
    forward's 128 Q rows, 64 at the 256-wide tile where its block is one
    warpgroup; dQ's 64 Q and dO rows; dK/dV's 64 K and V rows), its ring's
    stages (a 64-key K and V tile; dK/dV a q-tile of Q and dO and its lse
    and delta rows) and an 8-byte barrier for each load it waits on."""
    dp, ns = padded_head_dim(D), ring_stages(kernel, D)
    tile = BLOCK * dp * 2
    if kernel == "dkv":
        qt = 32 if dp >= 128 else 64   # the q-tile, tma_geometry's box rows
        stage = 2 * qt * dp * 2 + 2 * qt * 4
        return 1024 + 2 * tile + ns * stage + 8 * (1 + 2 * ns)
    kept = 1 if kernel == "fwd" and dp == 256 else 2   # Q (and dO) tiles
    return 1024 + (kept + 2 * ns) * tile + 8 * (1 + 2 * ns)
