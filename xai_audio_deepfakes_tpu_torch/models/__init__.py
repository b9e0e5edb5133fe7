"""UNet mask decoder, wav2vec2 embedder and LogReg head of the port."""
