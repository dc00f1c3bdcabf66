"""Closed-form ZeRO memory-needs estimators.

Port of ``deepspeed_tpu/runtime/zero/estimator.py`` (reference
``runtime/zero/stage_1_and_2.py:2423`` and ``stage3.py:2674``): the
bytes-per-parameter arithmetic of model states (mixed-precision params 2,
gradients 2, fp32 master and Adam moments 12, stage-2 buckets, offload
scenarios) and the ``_all_live`` / ``_all_cold`` table printers; the live
variants take a parameter tree (nested dicts of tensors or arrays). Model
states only, like the reference: activations are not counted.
"""

import math
from typing import Any, Optional, Tuple

import numpy as np


def convert_size(size_bytes: int) -> str:
    if size_bytes == 0:
        return "0B"
    names = ("B", "KB", "MB", "GB", "TB", "PB")
    i = int(math.floor(math.log(size_bytes, 1024)))
    p = math.pow(1024, i)
    return f"{round(size_bytes / p, 2)} {names[i]}"


def params_of_tree(params: Any) -> Tuple[int, int]:
    """(total_params, largest_layer_params) of a parameter tree. The largest
    layer follows the reference's ``model_to_params`` (``stage3.py:2714``):
    each dict contributes the sum of its immediate array leaves."""
    leaves = []

    def collect(node):
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            for v in node:
                collect(v)
        else:
            leaves.append(node)

    collect(params)
    if not leaves or not all(hasattr(l, "shape") for l in leaves):
        raise ValueError("params_of_tree expects a parameter tree of arrays or tensors, got "
                         f"{type(params).__name__}")
    size = lambda l: int(np.prod(tuple(l.shape))) if len(l.shape) else 1
    total = sum(size(l) for l in leaves)
    largest = 0

    def visit(node):
        nonlocal largest
        if isinstance(node, dict):
            children = list(node.values())
        elif isinstance(node, (list, tuple)):
            children = list(node)
        else:
            return
        largest = max(largest, sum(size(c) for c in children if hasattr(c, "shape")))
        for c in children:
            visit(c)

    visit(params)
    return total, largest or total


def estimate_zero2_model_states_mem_needs(total_params: int, num_chips_per_host: int = 1,
                                          num_hosts: int = 1, cpu_offload: bool = True,
                                          additional_buffer_factor: float = 1.5) -> Tuple[int, int]:
    """(host_mem, chip_mem) bytes for ZeRO-1/2 model states.

    Reference ``stage_1_and_2.py:2423`` — identical arithmetic."""
    total_chips = num_hosts * num_chips_per_host
    if cpu_offload:
        chip_mem = 2 * total_params
        host_mem = total_params * max(4 * total_chips, 16) * additional_buffer_factor
    else:
        chip_mem = 4 * total_params + int(16 * total_params / total_chips)
        host_mem = total_params * 4 * num_chips_per_host * additional_buffer_factor
    return int(host_mem), int(chip_mem)


def estimate_zero3_model_states_mem_needs(total_params: int, largest_layer_params: int,
                                          num_chips_per_host: int = 1, num_hosts: int = 1,
                                          cpu_offload: bool = True, cpu_offload_params: bool = True,
                                          zero_init: bool = True,
                                          additional_buffer_factor: float = 1.5) -> Tuple[int, int, int]:
    """(host_mem, chip_mem, largest_layer_mem) bytes for ZeRO-3 model states.

    Reference ``stage3.py:2674`` — identical arithmetic."""
    total_chips = num_hosts * num_chips_per_host
    host_factor = 1 / num_hosts
    largest_layer_memory = 4 * largest_layer_params

    if cpu_offload:
        if cpu_offload_params:
            chip_mem = largest_layer_memory
            if zero_init:
                host_mem = total_params * 18 * host_factor * additional_buffer_factor
            else:
                host_mem = total_params * max(4 * num_chips_per_host, 18 * host_factor) \
                    * additional_buffer_factor
        else:
            chip_mem = largest_layer_memory + int(2 * total_params / total_chips)
            if zero_init:
                host_mem = total_params * 16 * host_factor * additional_buffer_factor
            else:
                host_mem = total_params * max(4 * num_chips_per_host, 16 * host_factor) \
                    * additional_buffer_factor
    else:
        chip_mem = largest_layer_memory + int(18 * total_params / total_chips)
        if zero_init:
            host_mem = largest_layer_params * 4 * num_chips_per_host * additional_buffer_factor
        else:
            host_mem = total_params * 4 * num_chips_per_host * additional_buffer_factor
    return int(host_mem), int(chip_mem), largest_layer_memory


def _hw_header(total: int, num_chips_per_host: int, num_hosts: int, largest: Optional[int] = None) -> None:
    sw = f"SW: Model with {int(total / 1e6)}M total params"
    if largest is not None:
        sw += f", {int(largest / 1e6)}M largest layer params"
    print("Estimated memory needed for params, optim states and gradients for a:\n"
          f"HW: Setup with {num_hosts} host{'s' if num_hosts > 1 else ''}, "
          f"{num_chips_per_host} chip{'s' if num_chips_per_host > 1 else ''} per host.\n" + sw + ".")
    print("  per CPU  |  per Chip |   Options")


def estimate_zero2_model_states_mem_needs_all_cold(total_params: int, num_chips_per_host: int = 1,
                                                   num_hosts: int = 1,
                                                   additional_buffer_factor: float = 1.5) -> None:
    """Print the ZeRO-1/2 scenario table for a hypothetical model
    (reference ``stage_1_and_2.py:2477``)."""
    _hw_header(total_params, num_chips_per_host, num_hosts)
    for offload in (True, False):
        host, chip = estimate_zero2_model_states_mem_needs(
            total_params, num_chips_per_host, num_hosts, cpu_offload=offload,
            additional_buffer_factor=additional_buffer_factor)
        print(f"  {convert_size(host):>8} | {convert_size(chip):>8} | "
              f"offload_optimizer={'cpu' if offload else 'none'}")


def estimate_zero2_model_states_mem_needs_all_live(params, num_chips_per_host: int = 1,
                                                   num_hosts: int = 1,
                                                   additional_buffer_factor: float = 1.5) -> None:
    """Print the ZeRO-1/2 scenario table for a live parameter pytree."""
    total, _ = params_of_tree(params)
    estimate_zero2_model_states_mem_needs_all_cold(total, num_chips_per_host, num_hosts,
                                                   additional_buffer_factor)


def estimate_zero3_model_states_mem_needs_all_cold(total_params: int, largest_layer_params: int,
                                                   num_chips_per_host: int = 1, num_hosts: int = 1,
                                                   additional_buffer_factor: float = 1.5) -> None:
    """Print the ZeRO-3 scenario table for a hypothetical model
    (reference ``stage3.py:2757``)."""
    _hw_header(total_params, num_chips_per_host, num_hosts, largest_layer_params)
    for offload, offload_p, zinit in ((True, True, True), (True, True, False), (True, False, True),
                                      (True, False, False), (False, False, True), (False, False, False)):
        host, chip, _ = estimate_zero3_model_states_mem_needs(
            total_params, largest_layer_params, num_chips_per_host, num_hosts, cpu_offload=offload,
            cpu_offload_params=offload_p, zero_init=zinit,
            additional_buffer_factor=additional_buffer_factor)
        opts = (f"offload_param={'cpu' if offload_p else 'none'}, "
                f"offload_optimizer={'cpu' if offload else 'none'}, zero_init={int(zinit)}")
        print(f"  {convert_size(host):>8} | {convert_size(chip):>8} | {opts}")


def estimate_zero3_model_states_mem_needs_all_live(params, num_chips_per_host: int = 1,
                                                   num_hosts: int = 1,
                                                   additional_buffer_factor: float = 1.5,
                                                   largest_layer_params: Optional[int] = None) -> None:
    """Print the ZeRO-3 scenario table for a live parameter pytree
    (reference ``stage3.py:2726``). ``largest_layer_params`` overrides the
    derived per-group max (needed for ``scan_layers`` stacked trees)."""
    total, largest = params_of_tree(params)
    estimate_zero3_model_states_mem_needs_all_cold(total, largest_layer_params or largest,
                                                   num_chips_per_host, num_hosts,
                                                   additional_buffer_factor)
