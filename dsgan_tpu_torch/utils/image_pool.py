"""The discriminator's replay pool, on the device (port of
``dsgan_tpu/utils/image_pool.py``, reference DSGAN/util/image_pool.py).

Per batch element, in order:
  * while the pool is not full: store the image, return the image;
  * else with a coin > 0.5 swap it with a uniformly chosen stored image and
    return the old one; otherwise return the image unchanged.

The images stay on the device. How many are stored depends on no random
draw, so the count lives on the host and the insert-or-replay branch is
taken there without a sync; the coins and indices are device tensors and
the swap is a select, so a query never waits for the device. The draws
come from an explicit ``torch.Generator`` on the pool's device, or are
handed in (``draws=``), so a test can give the JAX pool's draws to both.
"""

import torch


class ImagePool:
    def __init__(self, pool_size, shape, dtype=torch.float32, device=None, seed=0):
        """``shape``: (C, H, W) of one pooled image."""
        self.pool_size = pool_size
        self.count = 0
        self.images = torch.zeros((max(pool_size, 1), *shape), dtype=dtype, device=device)
        self.generator = torch.Generator(device=self.images.device).manual_seed(seed)

    @property
    def full(self):
        """Whether every query from now on takes the replay branch (always,
        for a pool of size 0): the step's host-side path no longer moves."""
        return self.count >= self.pool_size

    def draws(self, n):
        """``n`` swap coins in [0, 1) and ``n`` pool indices, on the device."""
        dev = self.images.device
        coins = torch.rand((n,), generator=self.generator, device=dev)
        idx = torch.randint(0, self.pool_size, (n,), generator=self.generator, device=dev)
        return coins, idx

    def query(self, batch, draws=None):
        """``batch`` (B, C, H, W) -> the batch the discriminator sees.
        ``draws``: (coins (B,), indices (B,)) for the elements that meet a
        full pool; drawn from the pool's generator when not given."""
        if self.pool_size <= 0:
            return batch
        coins, idx = self.draws(batch.shape[0]) if draws is None else draws
        out = torch.empty_like(batch)
        for i in range(batch.shape[0]):
            img = batch[i]
            if self.count < self.pool_size:
                self.images[self.count] = img
                out[i] = img
                self.count += 1
                continue
            slot = idx[i:i + 1].to(self.images.device)
            old = self.images.index_select(0, slot)[0]
            swap = coins[i] > 0.5
            out[i] = torch.where(swap, old, img)
            self.images.index_copy_(0, slot, torch.where(swap, img, old)[None])
        return out
