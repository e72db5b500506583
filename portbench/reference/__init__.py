"""Plain torch reference of writeBloom / testBloom: ntHash from the C++
semantics, the filter's bits, per-read hit counts and the least bytes of
an insert or a query. It imports nothing of the port and reads nothing the
port computed: only the codes the benchmark made."""
