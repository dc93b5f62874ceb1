"""Data generators, one module per configuration's `data` name; each
makes its rows on the device from the run's seed, in a few large calls."""


def torch_seed(seed: int, part: int = 0) -> int:
    """The generator seed of one part (0 the training rows, 1 the test
    rows, ...) of a run's data: any whole number maps into the 63 bits
    torch.Generator takes."""
    return (int(seed) * 8 + part) % (1 << 63)
