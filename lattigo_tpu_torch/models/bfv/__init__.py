"""BFV: exact integer SIMD homomorphic encryption on PyTorch tensors.

The slice ported so far: parameters, context, encoder, key generation
(secret, public, relinearization and switching keys), encryption,
decryption, and the evaluator's linear ops, ``mul``, ``relinearize`` and
``switch_keys``.  Rotations come later.
"""

from lattigo_tpu_torch.models.bfv.context import BFVContext, get_context
from lattigo_tpu_torch.models.bfv.elements import Ciphertext, Plaintext
from lattigo_tpu_torch.models.bfv.encoder import Encoder
from lattigo_tpu_torch.models.bfv.encryptor import Decryptor, Encryptor
from lattigo_tpu_torch.models.bfv.evaluator import Evaluator
from lattigo_tpu_torch.models.bfv.keygen import (
    EvaluationKey,
    KeyGenerator,
    PublicKey,
    SecretKey,
    SwitchingKey,
)
from lattigo_tpu_torch.models.bfv.params import (
    PN12QP109,
    PN13QP218,
    PN14QP438,
    PN15QP880,
    Parameters,
    default_params,
)

__all__ = [
    "BFVContext", "Ciphertext", "Decryptor", "Encoder", "Encryptor",
    "EvaluationKey", "Evaluator", "KeyGenerator", "Parameters", "Plaintext",
    "PublicKey", "SecretKey", "SwitchingKey", "default_params", "get_context",
    "PN12QP109", "PN13QP218", "PN14QP438", "PN15QP880",
]
