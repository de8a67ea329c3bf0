"""Operator registry of the PyTorch port.

Counterpart of ``incubator_mxnet_tpu/ops/registry.py``. The op-name table
is the JAX package's, kept here as data (``_TABLE``: every canonical name
with its aliases, 304 names and 152 aliases): it is API surface. An op is a
plain function over tensors plus its attributes; ``register`` binds a name
of the table to one. This slice binds the ops of the eager gluon ResNet path
(FullyConnected, Convolution, BatchNorm, Pooling, Activation, Flatten,
softmax, log_softmax, pick, in ``ops/nn.py`` and ``ops/tensor.py``);
``get_op`` of any other name of the table raises NotImplementedError naming
ROADMAP Queue 1 item 10, and of a name outside it KeyError.
"""

__all__ = ["OpInfo", "register", "get_op", "list_ops", "table_names",
           "alias"]

# canonical op name -> its aliases, as the JAX package registers them
_TABLE = {
    "Activation": (),
    "AdaptiveAvgPooling2D": ("_contrib_AdaptiveAvgPooling2D",),
    "BatchNorm": ("BatchNorm_v1",),
    "BilinearResize2D": ("_contrib_BilinearResize2D",),
    "BilinearSampler": ("bilinear_sampler",), "BlockGrad": ("stop_gradient",),
    "CTCLoss": ("_contrib_CTCLoss", "_contrib_ctc_loss", "ctc_loss"),
    "Cast": ("cast",), "Concat": ("concat",),
    "Convolution": ("Convolution_v1",), "Correlation": ("correlation",),
    "Crop": (), "Deconvolution": (),
    "DeformableConvolution": ("_contrib_DeformableConvolution",
        "deformable_convolution"),
    "DeformablePSROIPooling": ("_contrib_DeformablePSROIPooling",
        "deformable_psroi_pooling"),
    "Dropout": (), "Embedding": (), "Flatten": ("flatten",),
    "FullyConnected": (), "GridGenerator": ("grid_generator",),
    "IdentityAttachKLSparseReg": (), "InstanceNorm": (),
    "L2Normalization": (), "LRN": (), "LayerNorm": (), "LeakyReLU": (),
    "LinearRegressionOutput": (), "LogisticRegressionOutput": (),
    "MAERegressionOutput": (),
    "MultiBoxDetection": ("_contrib_MultiBoxDetection", "multibox_detection"),
    "MultiBoxPrior": ("_contrib_MultiBoxPrior",),
    "MultiBoxTarget": ("_contrib_MultiBoxTarget", "multibox_target"),
    "MultiProposal": ("_contrib_MultiProposal", "multi_proposal"),
    "Pooling": ("Pooling_v1",), "Proposal": ("_contrib_Proposal", "proposal"),
    "RNN": (), "ROIAlign": ("_contrib_ROIAlign",),
    "ROIPooling": ("roi_pooling",), "Reshape": ("reshape",), "SVMOutput": (),
    "SequenceLast": (), "SequenceMask": (), "SequenceReverse": (),
    "SliceChannel": ("slice_channel", "split"), "SoftmaxActivation": (),
    "SoftmaxOutput": ("Softmax",),
    "SpatialTransformer": ("spatial_transformer",), "UpSampling": (),
    "_adamw_update": ("adamw_update",),
    "_contrib_group_adagrad_update": ("group_adagrad_update",),
    "_div_scalar": (), "_equal_scalar": (), "_grad_add": (),
    "_greater_equal_scalar": (), "_greater_scalar": (),
    "_histogram": ("histogram",), "_hypot_scalar": (),
    "_identity_with_attr_like_rhs": (), "_lesser_equal_scalar": (),
    "_lesser_scalar": (), "_logical_and_scalar": (), "_logical_or_scalar": (),
    "_logical_xor_scalar": (), "_maximum_scalar": (), "_minimum_scalar": (),
    "_minus_scalar": (), "_mod_scalar": (), "_mp_adamw_update": (),
    "_mul_scalar": (), "_not_equal_scalar": (), "_plus_scalar": (),
    "_power_scalar": (), "_ravel_multi_index": ("ravel_multi_index",),
    "_rdiv_scalar": (), "_rminus_scalar": (), "_rmod_scalar": (),
    "_rnn_param_concat": (), "_rpower_scalar": (),
    "_scatter_elemwise_div": (), "_scatter_minus_scalar": (),
    "_scatter_plus_scalar": (), "_scatter_set_nd": ("scatter_set_nd",),
    "_slice_assign": ("slice_assign",),
    "_slice_assign_scalar": ("slice_assign_scalar",),
    "_sparse_adagrad_update": (), "_split_v2": ("split_v2",),
    "_square_sum": (), "_unravel_index": ("unravel_index",),
    "_zeros_without_dtype": (), "abs": (), "adam_update": (),
    "add_n": ("ElementWiseSum", "_sum"), "allclose": ("_contrib_allclose",),
    "amp_cast": (), "amp_multicast": (), "arange": (), "arccos": (),
    "arccosh": (), "arcsin": (), "arcsinh": (), "arctan": (), "arctanh": (),
    "argmax": (), "argmax_channel": (), "argmin": (), "argsort": (),
    "batch_dot": (), "batch_take": (), "bernoulli": (), "boolean_mask": (),
    "box_iou": ("_contrib_box_iou",), "box_nms": ("_contrib_box_nms",),
    "broadcast_add": ("_add", "broadcast_add_alias", "broadcast_plus",
        "elemwise_add", "elemwise_plus"),
    "broadcast_arctan2": ("_arctan2", "elemwise_arctan2"),
    "broadcast_axis": ("broadcast_axes",),
    "broadcast_divide": ("_divide", "broadcast_div", "elemwise_div",
        "elemwise_divide"),
    "broadcast_equal": ("_equal", "elemwise_equal"),
    "broadcast_greater": ("_greater", "elemwise_greater"),
    "broadcast_greater_equal": ("_greater_equal", "elemwise_greater_equal"),
    "broadcast_hypot": ("_hypot", "elemwise_hypot"),
    "broadcast_lesser": ("_lesser", "elemwise_lesser"),
    "broadcast_lesser_equal": ("_lesser_equal", "elemwise_lesser_equal"),
    "broadcast_like": (),
    "broadcast_logical_and": ("_logical_and", "elemwise_logical_and"),
    "broadcast_logical_or": ("_logical_or", "elemwise_logical_or"),
    "broadcast_logical_xor": ("_logical_xor", "elemwise_logical_xor"),
    "broadcast_maximum": ("_maximum", "elemwise_maximum"),
    "broadcast_minimum": ("_minimum", "elemwise_minimum"),
    "broadcast_mod": ("_mod", "elemwise_mod"),
    "broadcast_multiply": ("_multiply", "broadcast_mul", "elemwise_mul",
        "elemwise_multiply"),
    "broadcast_not_equal": ("_not_equal", "elemwise_not_equal"),
    "broadcast_power": ("_power", "elemwise_power"),
    "broadcast_subtract": ("_subtract", "broadcast_minus", "broadcast_sub",
        "elemwise_sub", "elemwise_subtract"),
    "broadcast_to": (), "cbrt": (), "ceil": (), "choose_element_0index": (),
    "clip": (), "cos": (), "cosh": (),
    "count_sketch": ("_contrib_count_sketch",),
    "crf_decode": ("_contrib_crf_decode",), "crf_nll": ("_contrib_crf_nll",),
    "degrees": (), "depth_to_space": (), "dequantize": (), "diag": (),
    "dot": (), "erf": (), "erfinv": (), "exp": (), "expand_dims": (),
    "expm1": (), "eye": (), "fft": ("_contrib_fft",),
    "fill_element_0index": (), "fix": (), "flip": ("reverse",), "floor": (),
    "ftml_update": (), "ftrl_update": (), "full": (), "gamma": (),
    "gammaln": (), "gather_nd": (), "gelu": (),
    "gradient_multiplier": ("_contrib_gradientmultiplier",),
    "hard_sigmoid": (), "identity": ("_copy", "stop_gradient_off"),
    "ifft": ("_contrib_ifft",), "image_adjust_hue": (),
    "image_crop": ("_image_crop",),
    "image_flip_left_right": ("_image_flip_left_right",),
    "image_flip_top_bottom": ("_image_flip_top_bottom",),
    "image_normalize": ("_image_normalize",), "image_random_brightness": (),
    "image_random_contrast": (), "image_random_hue": (),
    "image_random_lighting": (), "image_random_rotate": (),
    "image_random_saturation": (), "image_resize": ("_image_resize",),
    "image_rotate": (), "image_to_tensor": ("_image_to_tensor",),
    "index_copy": ("_contrib_index_copy",),
    "khatri_rao": ("_contrib_khatri_rao",), "linalg_det": ("det",),
    "linalg_extractdiag": (), "linalg_extracttrian": (), "linalg_gelqf": (),
    "linalg_gemm": (), "linalg_gemm2": (), "linalg_inverse": ("inverse",),
    "linalg_makediag": (), "linalg_maketrian": (), "linalg_potrf": (),
    "linalg_potri": (), "linalg_slogdet": ("slogdet",),
    "linalg_sumlogdiag": (), "linalg_syevd": (), "linalg_syrk": (),
    "linalg_trmm": (), "linalg_trsm": (), "log": (), "log10": (), "log1p": (),
    "log2": (), "log_softmax": (), "logical_not": (),
    "make_loss": ("MakeLoss",), "max": (), "mean": (), "min": (),
    "mp_nag_mom_update": (), "mp_sgd_mom_update": (), "mp_sgd_update": (),
    "multi_mp_sgd_mom_update": (), "multi_mp_sgd_update": (),
    "multi_sgd_mom_update": (), "multi_sgd_update": (),
    "nag_mom_update": ("nag_update",), "nanprod": (), "nansum": (),
    "negative": (), "norm": (), "one_hot": (), "ones": (), "ones_like": (),
    "pad": ("Pad",), "pick": (), "prod": (),
    "quadratic": ("_contrib_quadratic",),
    "quantize_v2": ("_contrib_quantize_v2", "quantize"),
    "quantized_conv": ("_contrib_quantized_conv",),
    "quantized_flatten": ("_contrib_quantized_flatten",),
    "quantized_fully_connected": ("_contrib_quantized_fully_connected",),
    "quantized_pooling": ("_contrib_quantized_pooling",), "radians": (),
    "random_exponential": ("_random_exponential",),
    "random_gamma": ("_random_gamma", "gamma_sample"),
    "random_generalized_negative_binomial": (
        "_random_generalized_negative_binomial",),
    "random_negative_binomial": ("_random_negative_binomial",),
    "random_normal": ("_random_normal", "normal"),
    "random_poisson": ("_random_poisson",),
    "random_randint": ("_random_randint", "randint"),
    "random_uniform": ("_random_uniform", "uniform"), "rcbrt": (),
    "reciprocal": (), "relu": (), "repeat": (), "requantize": (),
    "reshape_like": (), "rint": (), "rmsprop_update": (),
    "rmspropalex_update": (), "round": (), "rsqrt": (),
    "sample_exponential_multi": ("_sample_exponential",),
    "sample_gamma_multi": ("_sample_gamma",),
    "sample_generalized_negative_binomial_multi": (
        "_sample_generalized_negative_binomial",),
    "sample_multinomial": ("_sample_multinomial", "multinomial"),
    "sample_negative_binomial_multi": ("_sample_negative_binomial",),
    "sample_normal_multi": ("_sample_normal",),
    "sample_poisson_multi": ("_sample_poisson",),
    "sample_uniform_multi": ("_sample_uniform",), "scatter_nd": (),
    "sgd_mom_update": (), "sgd_update": (), "shape_array": (),
    "shuffle": ("_shuffle",), "sigmoid": (), "sign": (), "signsgd_update": (),
    "signum_update": (), "sin": (), "sinh": (), "size_array": (),
    "slice": ("crop",), "slice_axis": (), "slice_like": (), "smooth_l1": (),
    "softmax": (), "softmax_cross_entropy": (), "softmin": (), "softsign": (),
    "sort": (), "space_to_depth": (), "sqrt": (), "square": (), "squeeze": (),
    "stack": (), "sum": (), "swapaxes": ("SwapAxis",), "swish": (),
    "take": (), "tan": (), "tanh": (), "tile": (), "topk": (),
    "transpose": (), "trunc": (), "where": (), "zeros": (), "zeros_like": (),
}

_CANONICAL = {a: name for name, aliases in _TABLE.items() for a in aliases}
_CANONICAL.update((name, name) for name in _TABLE)

_OP_REGISTRY = {}


class OpInfo:
    """Metadata for one bound operator."""

    def __init__(self, name, fn, num_outputs=1, aliases=(), attrs=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.aliases = tuple(aliases)
        self.attrs = dict(attrs or {})

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __repr__(self):
        return "OpInfo(%s)" % self.name


def _check_collision(names, override):
    if override:
        return
    taken = [n for n in names if n in _OP_REGISTRY]
    if taken:
        raise ValueError(
            "op name(s) %s already registered; pass override=True to "
            "replace deliberately" % ", ".join(repr(n) for n in taken))


def register(name=None, num_outputs=1, aliases=None, override=False,
             **attrs):
    """Decorator binding a function over tensors to an op name; the
    table's aliases of that name are bound with it."""
    def deco(fn):
        opname = name or fn.__name__
        names = tuple(aliases) if aliases is not None \
            else _TABLE.get(opname, ())
        _check_collision((opname,) + names, override)
        info = OpInfo(opname, fn, num_outputs=num_outputs, aliases=names,
                      attrs=attrs)
        for n in (opname,) + names:
            _OP_REGISTRY[n] = info
        return fn
    return deco


def alias(existing, *names, override=False):
    """Register additional names for an already-registered op."""
    info = _OP_REGISTRY[existing]
    _check_collision(names, override)
    for n in names:
        _OP_REGISTRY[n] = info


def get_op(name):
    """The bound op of ``name`` (or an alias); NotImplementedError for a
    name of the table that is not ported yet, KeyError for any other."""
    if name in _OP_REGISTRY:
        return _OP_REGISTRY[name]
    if name in _CANONICAL:
        raise NotImplementedError(
            "op %r is not ported yet (ROADMAP Queue 1 item 10)" % name)
    raise KeyError(name)


def list_ops():
    """Every canonical op name of the table, bound or not."""
    return sorted(_TABLE)


def table_names():
    """Every name of the table: canonical names and aliases."""
    return sorted(_CANONICAL)
