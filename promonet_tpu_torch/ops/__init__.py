from . import grid, mel, resblock, sparse, spectral, stft, viterbi
