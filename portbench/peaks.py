"""Published peaks of the cards the benchmark knows, by device name.

NVIDIA's H100 data sheet: the SXM part (``NVIDIA H100 80GB HBM3``) reads
3.35 TB/s of HBM3.  The rate holds at the card's full power limit; a
result line gives the limit it ran at.  Every roofline share of the
benchmark is bound by bytes (at most half a float64 flop a byte moved,
against the card's 20: 67 TFLOP/s over 3.35 TB/s), so the table holds no
flop rate; a metric that is bound by flops adds one.
"""

PEAKS = {
    # torch.cuda.get_device_name() -> HBM bytes/s
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak(device_name):
    """``{"hbm_bytes_per_s"}`` of a card, or None for a card the table does
    not hold (its roofline shares are then left out)."""
    bw = PEAKS.get(device_name)
    return None if bw is None else {"hbm_bytes_per_s": bw}
