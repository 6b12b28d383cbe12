"""CKKS: approximate complex-number homomorphic encryption on PyTorch tensors.

The slice ported so far: parameters, context, encoder, key generation
(dense and sparse secrets, public, relinearization, switching, rotation and
conjugation keys), encryption, decryption, and every method of the
evaluator (linear and constant ops, rescaling, multiplication with
relinearization, key switching, rotations, conjugation, hoisted
rotations), baby-step/giant-step and Chebyshev polynomial evaluation,
encrypted matrix-vector products (the hybrid diagonal method with hoisted
baby steps, ``linear_transform``), plaintext matrices of scalars applied to
stacks of ciphertexts (``plain_matrix``, ``Evaluator.mul_plain_matrix``) and
CryptoNets' MNIST network on them (``cryptonets``), the algorithms (powers,
Goldschmidt inverse), and ``JitEvaluator``, every op a ``tjit`` program (on
CUDA a captured graph).
"""

from lattigo_tpu_torch.models.ckks import algorithms, cryptonets
from lattigo_tpu_torch.models.bfv.keygen import PublicKey, SecretKey, SwitchingKey
from lattigo_tpu_torch.models.ckks.context import CKKSContext, get_context
from lattigo_tpu_torch.models.ckks.elements import Ciphertext, Plaintext
from lattigo_tpu_torch.models.ckks.encoder import Encoder
from lattigo_tpu_torch.models.ckks.encryptor import Decryptor, Encryptor
from lattigo_tpu_torch.models.ckks.evaluator import Evaluator, JitEvaluator
from lattigo_tpu_torch.models.ckks.keygen import EvaluationKey, KeyGenerator, RotationKeys
from lattigo_tpu_torch.models.ckks.linear_transform import (
    Diagonals,
    encode_diagonals,
    mul_matrix_hybrid,
)
from lattigo_tpu_torch.models.ckks.plain_matrix import PlainMatrix
from lattigo_tpu_torch.models.ckks.params import (
    PN12QP109,
    PN13QP218,
    PN14QP438,
    PN15QP880,
    PN16QP1761,
    Parameters,
    default_params,
)
from lattigo_tpu_torch.models.ckks.polynomial_evaluation import (
    ChebyshevInterpolation,
    approximate,
    evaluate_cheby_eco,
    evaluate_cheby_fast,
    evaluate_poly_eco,
    evaluate_poly_fast,
)

__all__ = [
    "CKKSContext", "ChebyshevInterpolation", "Ciphertext", "Decryptor", "Diagonals", "Encoder",
    "Encryptor",
    "EvaluationKey", "Evaluator", "JitEvaluator", "KeyGenerator", "Parameters", "PlainMatrix",
    "Plaintext",
    "PublicKey", "RotationKeys", "SecretKey", "SwitchingKey", "default_params",
    "get_context", "PN12QP109", "PN13QP218", "PN14QP438", "PN15QP880", "PN16QP1761",
    "algorithms", "approximate", "cryptonets", "evaluate_cheby_eco", "evaluate_cheby_fast",
    "encode_diagonals", "evaluate_poly_eco", "evaluate_poly_fast", "mul_matrix_hybrid",
]
