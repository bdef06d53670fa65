"""Hardware table of the port's target: one NVIDIA H100 SXM (sm_90a).

Peak rates are NVIDIA's data-sheet dense figures at the full 700 W power
limit; a card set below it runs slower under load, so a measured time is
reported beside the card's power limit. ``bound_ms`` is the least time the
card could take: the larger of bytes over the memory rate and operations
over the peak rate of their type.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    num_sms: int
    smem_per_block: int        # bytes a block may use (dynamic, after opt-in)
    l2_bytes: int
    hbm_bytes_per_s: float
    bf16_flops: float          # dense tensor-core rate
    fp8_flops: float
    tf32_flops: float
    # The in-kernel planar FP4 route's rate in fp4_inkernel_profitable's
    # model, TFLOP/s: fitted so that the model's crossover falls where
    # chip_smoke.py (phase 10) measures the two routes cross, as the JAX
    # package fits its column to its own chip (deepgemm_tpu/heuristics/
    # arch.py:55-60). A model parameter, not a rate the card reaches: the
    # port's fold route pays a torch decode that the model's 2.5 bytes a
    # value undercount, and the fit absorbs it. Both routes run the wgmma
    # kernel. chip_smoke.py phase 10 prints each run's crossover and fit
    # (lines through the op times at m 128 and 4096, n 7168, k 2048; NVIDIA
    # H100 80GB HBM3, 700 W). Three runs put it at m ~17500, ~18800 and
    # ~303000 (fits 1728.6, 1732.1, 1778.0): the fold's time is mostly its
    # host-side torch decode, which varies from machine to machine. The
    # value is the median.
    fp4_decode_tflops: float
    # NVLink, each way, to the other cards of the host: the link of an
    # expert-parallel mesh across cards (heuristics/mega.py). Ranks that
    # share one card move their bytes through its HBM instead.
    link_bytes_per_s: float = 450e9

    def bound_ms(self, num_bytes: float, flops: float, operands: str):
        """(least milliseconds, 'bytes' | 'operations'); the operations at
        the rate of ``operands``: 'fp8', 'bf16' or 'tf32'."""
        t_bytes = num_bytes / self.hbm_bytes_per_s * 1e3
        rate = {'fp8': self.fp8_flops, 'bf16': self.bf16_flops, 'tf32': self.tf32_flops}[operands]
        t_ops = flops / rate * 1e3
        return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


H100_SXM = ArchSpec(name='H100 SXM', num_sms=132, smem_per_block=232448,
                    l2_bytes=50 << 20, hbm_bytes_per_s=3.35e12,
                    bf16_flops=989e12, fp8_flops=1979e12, tf32_flops=495e12,
                    fp4_decode_tflops=1732.0)


def detect_arch() -> ArchSpec:
    """The running card's row. The port targets one part, so every device
    (the CPU of the tests included) resolves to the H100's row."""
    return H100_SXM


def fp4_inkernel_profitable(arch: ArchSpec, m: int, n: int, k: int) -> bool:
    """Whether planar FP4 B is cheaper decoded in the kernel than folded
    first (deepgemm_tpu/heuristics/arch.py:89-109, the same model):

    - fold:      decode the codes to e4m3 before the GEMM, which then runs at
                 the fp8 rate (0.9 of peak, JAX's factor for a direct fp8
                 path); B moves 2.5x its packed bytes (read, write, read);
    - in-kernel: stream the packed bytes once (0.5 a value) and decode them
                 in registers, at ``arch.fp4_decode_tflops``.

    In-kernel wins where the weight bytes, not the operations, set the time:
    small m."""
    flops = 2.0 * m * n * k
    t_fold = flops / (0.9 * arch.fp8_flops) + n * k * 2.5 / arch.hbm_bytes_per_s
    t_inkernel = flops / (arch.fp4_decode_tflops * 1e12) + n * k * 0.5 / arch.hbm_bytes_per_s
    return t_inkernel < t_fold
