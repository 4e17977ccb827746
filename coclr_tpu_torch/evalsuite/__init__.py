"""The evaluation suite of the port (coclr_tpu/evalsuite): finetune and
linear probe, retrieval, the N-crop test, the feature-cache probe and
two-stream fusion."""
