"""Each epoch's injected noise words, drawn as the port draws them.

A frozen copy of ``theanet_tpu_torch.ops.megastep.epoch_noise_bits`` (its
generator seeding and its layout) for the benchmark's nets, so that the
reference works out the words itself and takes none from the program. The
words are drawn on the device the reference runs on; on the same device
and seed they are the port's words, bit for bit (the CPU test holds the
two copies equal).
"""

from __future__ import annotations

import numpy as np
import torch


def epoch_noise_bits(seed, epoch, net, n_batches, device):
    """(ub (nb, 1, 8), fb (nb, 4, HW), pb (nb, C0*B, HW), db (nb, B, n_hid))
    int32 words of epoch ``epoch``: the affine scalars, the Box-Muller words
    of the elastic field, the pflip uniforms and the dropout uniforms, from a torch.Generator on
    ``device`` seeded by (seed, epoch)."""
    state = np.random.SeedSequence([int(seed), int(epoch)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             generator=gen, device=device)

    B, HW, C0 = net.batch, net.hw, net.in_ch
    return (words(n_batches, 1, 8), words(n_batches, 4, HW),
            words(n_batches, C0 * B, HW), words(n_batches, B, net.n_hid))
