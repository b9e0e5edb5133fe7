"""The benchmark of the PyTorch/CUDA port (`xai_audio_deepfakes_tpu_torch`):
one process per run, `python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`, cells named in `BENCHMARK.json`."""
