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

    def bound_ms(self, num_bytes: float, flops: float, operands: str):
        """(least milliseconds, 'bytes' | 'operations'); the operations at
        the rate of ``operands``: 'fp8', 'bf16' or 'tf32'."""
        t_bytes = num_bytes / self.hbm_bytes_per_s * 1e3
        rate = {'fp8': self.fp8_flops, 'bf16': self.bf16_flops, 'tf32': self.tf32_flops}[operands]
        t_ops = flops / rate * 1e3
        return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


H100_SXM = ArchSpec(name='H100 SXM', num_sms=132, smem_per_block=232448,
                    l2_bytes=50 << 20, hbm_bytes_per_s=3.35e12,
                    bf16_flops=989e12, fp8_flops=1979e12, tf32_flops=495e12)
