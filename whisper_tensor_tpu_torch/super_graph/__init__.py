"""Super-graph payload types. Only `links.Image` is ported yet; the
reference's super graphs (whisper_tensor_tpu/super_graph/) wait for a
later media slice (ROADMAP A9)."""
