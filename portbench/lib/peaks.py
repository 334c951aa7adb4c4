"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets; SXM parts, dense rates), by the name ``torch.cuda.get_device_name``
gives.  Each assumes the card's full power limit, which the result line's
card name goes with."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops": 67e12,
        "bf16_flops": 989e12,
    },
}


def peak(kind: str, name: str) -> float:
    """The peak ``name`` of card ``kind``; raises for a card the table lacks,
    so no share is reported against a guess."""
    try:
        return PEAKS[kind][name]
    except KeyError:
        raise KeyError(f"no published {name} for {kind!r}") from None
