"""Request kind ``cryptonets``: CryptoNets' MNIST network (Gilad-Bachrach
et al., ICML 2016) on a batch of encrypted images, one image a slot
(``ckks.cryptonets.Network`` on the plain ``ckks.Evaluator``: three
``mul_plain_matrix`` layers, each a launch of ``csrc/ct_matrix.cu``, two
stacked squares by ``mul_relin`` with the relinearization key, a
``rescale`` after each), the whole network as one ``tjit`` program.

The benchmark draws from the seed the sparse ternary secret, the weights
and biases, and for each pool entry a batch of images
(``reference/cryptonets.py``).  It encodes the images itself, pixel i of
every image into ciphertext i (the reference's canonical embedding at the
configuration's scale); the port generates the public and relinearization
keys from that secret, takes the plaintexts to its NTT domain and
encrypts them as one stack with ``ckks.Encryptor`` (each with draws of its
own): one ciphertext whose polys are [pixels, L, N].  The padding pixels are zeros
known to the server: they are not encrypted.  The weights and biases live
in the program, as the layers' integer tables.  A request is one call of
the program on one pool entry.

The reference decrypts every answer ciphertext of each sampled pool entry
with the secret, decodes it at the level and scale Lattigo's rules leave
and holds every logit of every image against its float64 network.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fhe_bench.apps.ckks_mul_relin_rescale import parameters
from fhe_bench.reference import cheby as ref_cheby
from fhe_bench.reference import ckks as ref
from fhe_bench.reference import cryptonets as ref_net
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.models.bfv import SecretKey
from lattigo_tpu_torch.tjit import tjit

WEIGHTS = ("conv_w", "conv_b", "w1", "b1", "w2", "b2")


def result_form(cfg: dict) -> tuple[float, int]:
    """The answer's scale and level: inputs at the set's scale and top
    level through the network's five rescaled steps."""
    scheme = ref.Scheme(cfg)
    _, scale, level = ref_net.trace(scheme.qs, scheme.scale, len(scheme.qs) - 1)
    return scale, level


class App:
    """The cell's program, its inputs and what the reference needs."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        params = parameters(cfg)
        want = ref.moduli(cfg)
        if (list(params.qi), list(params.pi)) != (want["q"], want["p"]):
            raise RuntimeError("the port's moduli differ from Lattigo's for this configuration")
        self.cfg, self.device = cfg, device
        ctx = ckks.get_context(params, device)
        rq, rqp = ctx.ring_q, ctx.ring_qp
        self.secret, self.w, self.pixels = ref_net.draw(cfg, wl["pool"], seed)
        dtype = np.dtype(cfg["weights_dtype"])
        weights = {k: self.w[k].astype(dtype).astype(np.float64) for k in WEIGHTS}
        self.net = ckks.cryptonets.Network.of(*(weights[k] for k in WEIGHTS), image=cfg["image"],
                                               padded=cfg["padded"], stride=cfg["stride"])
        seeds = np.random.SeedSequence(seed).generate_state(2, dtype=np.uint64) >> np.uint64(1)

        res = torch.tensor(np.stack([self.secret % q for q in rqp.moduli]), dtype=torch.int64,
                           device=device)
        sk = SecretKey(rqp.ntt(rqp.mform(res)))
        kgen = ckks.KeyGenerator(params, device=device, seed=int(seeds[0]))
        self.rlk = kgen.gen_relin_key(sk)
        encryptor = ckks.Encryptor(params, pk=kgen.gen_public_key(sk), device=device,
                                   seed=int(seeds[1]))
        q_col = torch.tensor(list(rq.moduli), dtype=torch.int64, device=device)[:, None]
        scheme = ref.Scheme(cfg)
        pixels = cfg["image"] ** 2
        self.cts = []
        for batch in self.pixels:  # [images, image, image]
            slots = batch.reshape(len(batch), pixels).T.astype(np.complex128)
            pts = rq.ntt(torch.from_numpy(scheme.encode(slots)).to(device)[:, None, :] % q_col)
            self.cts.append(encryptor.encrypt(ckks.Plaintext(pts, params.scale)))
            del pts
        ev = ckks.Evaluator(params, device=device)
        net = self.net

        def forward(ct, rlk):
            return net.forward(ev, ct, rlk)

        self.program = tjit(forward)
        self.pool = wl["pool"]

    def call(self, k: int) -> ckks.Ciphertext:
        """One request: the network on pool entry ``k``'s images."""
        return self.program(self.cts[k], self.rlk)

    def release(self) -> None:
        """Frees the program, its key, layers and inputs; what the
        reference needs stays."""
        del self.program, self.cts, self.rlk, self.net

    def judge(self, answers: dict[int, ckks.Ciphertext]) -> dict:
        """The numbers compared, over the sampled answers (pool index ->
        answer): ``bad_form`` (answers not of degree 1 with one ciphertext
        a class at the level and scale of :func:`result_form`),
        ``limb_mismatch`` (as ``reference.cheby.decrypt`` counts it: the
        message is decrypted through two limbs), ``max_err`` (the largest
        |slot - logit| over every class and image) and ``out_of_range``
        (words outside [0, q_i))."""
        cfg = self.cfg
        scheme = ref.Scheme(cfg)
        scale, level = result_form(cfg)
        secret = torch.from_numpy(self.secret).to(self.device)
        shape = (2, cfg["classes"], level + 1, scheme.n)
        out = dict(bad_form=0, limb_mismatch=0, max_err=0.0, out_of_range=0)
        for k, ans in sorted(answers.items()):
            ct = torch.stack(ans.value) if len(ans.value) == 2 else None
            if ct is None or tuple(ct.shape) != shape or not math.isclose(
                    ans.scale, scale, rel_tol=1e-12):
                out["bad_form"] += 1
                continue
            coeffs, mismatch = ref_cheby.decrypt(scheme.qs[: level + 1], scheme.n, ct, secret)
            out["limb_mismatch"] += mismatch
            want = ref_net.expected(cfg, self.w, self.pixels[k])  # [images, classes]
            got = scheme.decode(coeffs, scale)  # [classes, images]
            out["max_err"] = max(out["max_err"], float(np.abs(got - want.T).max()))
            q = torch.tensor(scheme.qs[: level + 1], dtype=torch.int64, device=ct.device)[:, None]
            out["out_of_range"] += int(((ct < 0) | (ct >= q)).sum())
        return out


def control_config(cfg: dict, control: str = "scale") -> dict:
    """A control: the same deployment at the precision below the one its
    configuration states, which the cell's limits must find not correct.
    ``scale``: the scale 2^30 for the 2^34 it states (the rescale rule then
    leaves the convolution unrescaled at level 9, and the answer at another
    scale, which ``judge`` reads from this configuration);
    ``float16``: the weights and biases rounded to float16 before they are
    encoded, the reference keeping them in float64."""
    if control == "scale":
        return dict(cfg, scale=1 << 30)
    if control == "float16":
        return dict(cfg, weights_dtype="float16")
    raise ValueError(f"no control {control!r}")
