"""Device random fills (port of ``gunrock_tpu/ops/random.py``; role of
reference ``generate/random.hxx:20-33``, a thrust fill from a host seed).

Each call seeds its own ``torch.Generator`` on ``device``, so a fill is
deterministic per (seed, device). The stream is not JAX's threefry, and
the CPU's and the card's generators give different streams for one seed:
hold these fills to their range, dtype, shape and determinism, not to
the JAX package's values.
"""

from __future__ import annotations

import torch

from gunrock_tpu_torch.device import DEFAULT, resolve


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def uniform(n: int, seed: int = 0, low: float = 0.0, high: float = 1.0,
            dtype=torch.float32, device=DEFAULT) -> torch.Tensor:
    """float fill over [low, high) (uniform_distribution(float) parity)."""
    dev = resolve(device)
    u = torch.rand(n, generator=_generator(seed, dev), dtype=dtype, device=dev)
    return low + (high - low) * u


def uniform_int(n: int, seed: int = 0, low: int = 0, high: int = 2**31 - 1,
                device=DEFAULT) -> torch.Tensor:
    """int32 fill over [low, high) (uniform_distribution(int) parity)."""
    dev = resolve(device)
    return torch.randint(low, high, (n,), generator=_generator(seed, dev),
                         dtype=torch.int32, device=dev)
