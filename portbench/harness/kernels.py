"""Which layer a device operation of the trace belongs to, by the names
the port's kernels and the libraries under it give them."""

import re

#: the port's euler trajectory kernels and their adjoints (#1/#2 RBF,
#: #7/#8 DF), the adjoints' summing kernels included
FLOW = re.compile(r'\b(df_)?flow_fused_(fwd_kernel|bwd_kernel|bwd_finish)\b')
#: cuDNN's convolution kernels (its FFT algorithm's transforms and
#: complex GEMMs included) and BatchNorm kernels: the conv VAE; the dense
#: layers' GEMMs fall in with them by name
VAE = re.compile(r'cudnn|conv|dgrad|wgrad|fprop|implicit_gemm|xmma|fft2d|'
                 r'bn_fw|bn_bw|batch_norm|nchwToNhwc|nhwcToNchw', re.I)
#: cuSOLVER's and cuBLAS's Cholesky and triangular-solve kernels (the GP
#: draw's factorisation of the gram and its solves)
GP_DRAW = re.compile(r'potrf|potf2|getrf|trsm|trsv|trtri|syrk|cholesky|'
                     r'lapack|magma', re.I)


def flow(name):
    return FLOW.search(name) is not None


def vae(name):
    return VAE.search(name) is not None


def gp_draw(name):
    return GP_DRAW.search(name) is not None
