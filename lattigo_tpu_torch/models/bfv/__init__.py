"""BFV: exact integer SIMD homomorphic encryption on PyTorch tensors.

Parameters, context, encoder, key generation (secret, sparse secret,
public, relinearization, switching and rotation keys), encryption (also
from a common reference polynomial), decryption, and the evaluator's linear
ops, ``mul``, ``relinearize``, ``switch_keys``, ``rotate_columns``,
``rotate_rows`` and ``inner_sum``.
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
    RotationKeys,
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
    "PublicKey", "RotationKeys", "SecretKey", "SwitchingKey", "default_params", "get_context",
    "PN12QP109", "PN13QP218", "PN14QP438", "PN15QP880",
]
