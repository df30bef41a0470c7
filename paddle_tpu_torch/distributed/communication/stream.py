"""Stream-variant collectives (``communication/stream/all_reduce.py``'s
``use_calc_stream``): the port's collectives enqueue on the caller's
current stream, so the stream variants share the one implementation, as
in the JAX package."""

from ..parallel_base import (ReduceOp, all_gather as _ag,
                             all_reduce as _ar, alltoall as _a2a,
                             broadcast as _bc, reduce as _rd,
                             reduce_scatter as _rs, scatter as _sc)


def all_reduce(tensor, op=None, group=None, sync_op=True,
               use_calc_stream=False):
    return _ar(tensor, op or ReduceOp.SUM, group, sync_op)


def all_gather(tensor_or_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    return _ag(tensor_or_list, tensor, group, sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _bc(tensor, src, group, sync_op)


def reduce(tensor, dst=0, op=None, group=None, sync_op=True,
           use_calc_stream=False):
    return _rd(tensor, dst, op or ReduceOp.SUM, group, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True,
            use_calc_stream=False):
    return _sc(tensor, tensor_list, src, group, sync_op)


def reduce_scatter(tensor, tensor_list, op=None, group=None, sync_op=True,
                   use_calc_stream=False):
    return _rs(tensor, tensor_list, op or ReduceOp.SUM, group, sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    return _a2a(out_tensor_list, in_tensor_list, group, sync_op)
