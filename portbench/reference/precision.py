"""Arithmetic of the reference: exact float32, or the float8 control

Every convolution, matrix product and recurrent cell of the reference
passes its operands through `operand` and its result through `result`.
`Exact` leaves them as they are (float32, TF32 off: see `exact`).
`Float8` is the control: the program computes in bfloat16 (operands and
results of each product rounded to it), the control in the nearest
precision below, float8 e4m3. Each operand and each float32 result is
rounded to e4m3 under a per-tensor scale that maps its largest
magnitude to e4m3's largest, 448, as scaled float8 arithmetic takes
it. The stages' inputs (audio, features) go through `operand` too.
"""
import contextlib

import torch

E4M3_MAX = 448.


class Exact:
    """float32 throughout"""

    def operand(self, x):
        return x

    def result(self, x):
        return x


class Float8:
    """Scaled float8 e4m3 operands and results"""

    def operand(self, x):
        """The rounded value; in training the gradient passes straight
        through the rounding"""
        x = x.float()
        scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / E4M3_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x).detach()

    result = operand


EXACT = Exact()
FLOAT8 = Float8()


@contextlib.contextmanager
def exact():
    """TF32 off for the reference's matrix products and convolutions,
    restored afterwards"""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
