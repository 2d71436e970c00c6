"""repro_torch.compiler — make_fx graph -> TM IR -> optimization passes ->
scheduled TMProgram.

The lowering pipeline that turns a plain PyTorch function into the paper's
system-level execution form: tensor-manipulation work on the TM engine,
compute on the compute engine, forwarded edges overlapping the two.

    from repro_torch.compiler import tm_compile
    compiled = tm_compile(fn, *example_args)
    y = compiled(*args, backend="cuda")
    print(compiled.report())
"""

from repro_torch.compiler.api import CompiledTMProgram, tm_compile

__all__ = ["CompiledTMProgram", "tm_compile"]
