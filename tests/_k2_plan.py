"""The invariants of K2b's row split (pydnmfk_tpu_torch.ops.kl.wtu_split_plan),
shared by the CPU test of the plan and the gpu test of the geometry that
csrc/kl_ratio.cu exports."""
from pydnmfk_tpu_torch.ops import kl

# (members, m, n, k): the refit's single member and the 10-member ensemble
# of the NMFk sweep (at k <= 32 and at k = 64, the 3xTF32 kernels' width),
# the strong-scaling shape, a member too short for a
# second chunk, ragged m at every chunk height, a width whose strips alone
# fill the card many times, and the first-port widths (no split)
PLAN_CASES = [(1, 14400, 9600, 8), (10, 14400, 9600, 4), (1, 14400, 9600, 64),
              (10, 14400, 9600, 64), (1, 57600, 38400, 32),
              (1, 200, 300, 8), (1, 1000, 130, 3), (1, 1001, 70, 16),
              (3, 999, 65, 17), (1, 3000, 260, 32), (1, 4096, 2 ** 22, 8),
              (1, 100000, 50, 1), (2, 5000, 700, 64), (1, 9000, 40, 256)]
H100_SMS = 132


def check_plan(B, m, n, k, strip, chunk, sms=H100_SMS):
    """The ranges [s R, min(m, (s + 1) R)) of the splits are non-empty and
    cover the rows [0, m) of a member exactly once; R is a whole number of
    W chunks when there is more than one split; the members split only
    while their strips are fewer than the SMs, and add blocks only up to
    the target; and the partial sums (splits, B, k, n) stay within their
    stated cap of 2 x target x strip x k values."""
    target = kl.SPLIT_BLOCKS_PER_SM * sms
    splits, rows = kl.wtu_split_plan(B, m, n, k, strip, chunk, sms)
    ranges = [range(s * rows, min(m, (s + 1) * rows)) for s in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    assert [i for r in ranges for i in r] == list(range(m))
    if splits == 1:
        assert rows == m
        return splits
    blocks = B * -(-n // strip)
    assert strip > 0 and rows % chunk == 0
    assert blocks < sms and (splits - 1) * blocks < target
    assert splits * B * k * n < 2 * target * strip * k
    return splits
