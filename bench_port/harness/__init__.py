"""What every cell shares: seeds, weights, the trace reader, the result line."""
