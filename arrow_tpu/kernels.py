"""Flat kernel namespace (≙ the umbrella crate's ``arrow_gpu::kernels``,
`crates/arrow/src/kernels.rs:1-8`).

Every op is available here in both eager (``foo``) and pipelined (``foo_op``)
form, plus the ``*_dyn`` aliases of the reference's enum-dispatch functions.
"""

from .ops.aggregate import (  # noqa: F401
    max_reduce,
    min_reduce,
    sum_,
    sum_dyn,
    sum_op,
    sum_op_dyn,
)
from .ops.arithmetic import *  # noqa: F401,F403
from .ops.arithmetic import neg, neg_dyn, neg_op, neg_op_dyn  # noqa: F401
from .ops.broadcast import (  # noqa: F401
    broadcast,
    broadcast_dyn,
    broadcast_op,
    broadcast_op_dyn,
)
from .ops.cast import (  # noqa: F401
    bitcast,
    bitcast_dyn,
    bitcast_op,
    bitcast_op_dyn,
    cast,
    cast_dyn,
    cast_op,
    cast_op_dyn,
)
from .ops.compare import *  # noqa: F401,F403
from .ops.logical import *  # noqa: F401,F403
from .ops.logical import all_, any_, bitwise_not, not_  # noqa: F401
from .ops.math_ops import *  # noqa: F401,F403
from .ops.math_ops import power, power_dyn, power_op, power_op_dyn  # noqa: F401
from .ops.swizzle import (  # noqa: F401
    merge,
    merge_dyn,
    merge_op,
    merge_op_dyn,
    put,
    put_dyn,
    put_op,
    put_op_dyn,
    take,
    take_dyn,
    take_op,
    take_op_dyn,
)
from .ops.trigonometry import *  # noqa: F401,F403
