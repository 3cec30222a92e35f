"""What the recipes' plain training steps share, in PyTorch, float32 (TF32
off): the uint8 mapping, the serving function, the replay pool, Adam, and
the trainer each recipe's module (``reference/<recipe>.py``, named by the
configuration's ``reference`` key) builds on.

A step takes one batch of uint8 (B, H, W, 3) images per side and runs it in
slices of ``micro`` images, summing the slices' gradients, so that the
reference fits beside nothing else on one card at the benchmark's batch;
the slices' parts of each loss add up to the whole batch's
(``losses``). Every network here normalizes per image (InstanceNorm), so a
slice computes what the whole batch would.

Adam: betas (beta1, 0.999), eps 1e-8, no weight decay, the configuration's
learning rate.
"""

import torch


def normalize(x):
    """uint8 (B, H, W, C) -> [-1, 1] float32 (B, C, H, W)."""
    return (x.float() / 255.0 * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous()


def quantize(y):
    """[-1, 1] (B, C, H, W) -> uint8 (B, H, W, C): clip, then floor."""
    v = torch.clamp((y + 1.0) / 2.0 * 255.0, 0.0, 255.0)
    return torch.floor(v).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def serve(netG, x_u8):
    """The generator's serving function: uint8 in, uint8 out."""
    with torch.no_grad():
        return quantize(netG(normalize(x_u8)))


def require(opts, **expected):
    """Raise unless ``opts`` holds each expected value: a reference module
    computes one architecture, and a configuration that names another needs
    a module of its own."""
    wrong = {k: opts.get(k) for k, v in expected.items() if opts.get(k) != v}
    if wrong:
        raise ValueError(f"this reference computes {expected}, the configuration has {wrong}")


class ReplayPool:
    """The discriminator's replay pool (yglbgyx/DS-GAN ``util/image_pool.py``).

    Per image of a query, in order: while the pool is not full the image is
    stored and handed back; once full, a coin above 0.5 swaps it with a
    stored image chosen uniformly and hands back the stored one, any other
    coin hands back the image. Each query draws its coins and indices from
    ``generator``, ``torch.rand(n)`` then ``torch.randint(0, size, (n,))``, so
    that two pools started from one generator state meet the same picks. A
    pool without a generator is followed only while it fills: a query that
    would meet it full raises.
    """

    def __init__(self, size, images=None, count=0, generator=None):
        self.size, self.images, self.count, self.generator = size, images, count, generator

    def query(self, batch):
        if self.size <= 0:
            return batch
        n = batch.shape[0]
        coins = idx = None
        if self.generator is not None:
            dev = self.generator.device
            coins = torch.rand((n,), generator=self.generator, device=dev).tolist()
            idx = torch.randint(0, self.size, (n,), generator=self.generator, device=dev).tolist()
        elif self.count + n > self.size:
            raise ValueError("a pool without a generator is followed only while it fills")
        if self.images is None:
            self.images = batch.new_zeros((self.size, *batch.shape[1:]))
        out = []
        for i in range(n):
            img = batch[i]
            if self.count < self.size:
                self.images[self.count] = img
                self.count += 1
                out.append(img)
            elif coins[i] > 0.5:
                out.append(self.images[idx[i]].clone())
                self.images[idx[i]] = img
            else:
                out.append(img)
        return torch.stack(out)


def adam(params, opts):
    return torch.optim.Adam(list(params), lr=opts["lr"], betas=(opts["beta1"], 0.999), eps=1e-8,
                            foreach=False)


def slices(n, micro):
    return [slice(i, min(i + micro, n)) for i in range(0, n, micro)]


class Trainer:
    """One recipe's networks, optimizers and pools; ``step`` runs a batch.

    A recipe sets ``TRAINED`` (its trained networks, by the program's
    names), ``POOLS`` (how many replay pools), ``optimizers()`` (the G and
    the D Adam) and ``run(a, b)`` (one step on normalized batches, its
    losses as floats under the program's metric names). Its module also
    names ``LOSSES``, ``SERVED`` (the network a serving cell serves),
    ``KERNEL_LEAVES`` (a pattern of the leaves the ``kernel_`` numbers of
    ``correct.py`` take), ``build_nets`` and ``counted_step``.
    ``first_grads``: each trained parameter's gradient at the first step,
    by ``<net>.<name>``, kept by ``run`` before the last optimizer step.
    """

    TRAINED = ()
    POOLS = 1

    def __init__(self, nets, opts, micro=4):
        self.nets, self.opts, self.micro = nets, opts, micro
        for net in nets.values():
            net.train()
        self.opt_G, self.opt_D = self.optimizers()
        self.pools = [ReplayPool(opts["pool_size"]) for _ in range(self.POOLS)]
        self.first_grads = None

    def named_parameters(self):
        return {f"{k}.{n}": p for k in self.TRAINED for n, p in self.nets[k].named_parameters()}

    def keep_first_grads(self, names=None):
        if self.first_grads is None:
            self.first_grads = {}
        for k, p in self.named_parameters().items():
            if (names is None or k.split(".", 1)[0] in names) and k not in self.first_grads:
                self.first_grads[k] = p.grad.detach().clone()

    def load_state(self, state):
        """Take up a training state part way through: ``state["params"]``
        and ``state["adam"]`` ({leaf: {"step", "exp_avg", "exp_avg_sq"}}) by
        leaf, ``state["pools"]`` a list of (images, count, generator state)
        in the order of ``pools``. The pools draw from generators on the
        networks' device set to those states."""
        params = self.named_parameters()
        owner = {id(p): opt for opt in (self.opt_G, self.opt_D)
                 for g in opt.param_groups for p in g["params"]}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(state["params"][k])
                st = state["adam"][k]
                owner[id(p)].state[p] = {
                    "step": torch.tensor(float(st["step"])),
                    "exp_avg": st["exp_avg"].to(p.device, p.dtype).clone(),
                    "exp_avg_sq": st["exp_avg_sq"].to(p.device, p.dtype).clone()}
        dev = next(iter(params.values())).device
        self.pools = []
        for images, count, gen_state in state["pools"]:
            gen = torch.Generator(device=dev)
            gen.set_state(gen_state)
            self.pools.append(ReplayPool(self.opts["pool_size"], images.to(dev).clone(), count,
                                         gen))

    def step(self, a_u8, b_u8):
        """One step on uint8 (B, H, W, 3) device batches; its losses as
        floats, under the program's metric names."""
        return self.run(normalize(a_u8), normalize(b_u8))
