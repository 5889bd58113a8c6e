"""Port of langsplatv2_tpu/eval/ (quick-model merge, prompt relevancy)."""
