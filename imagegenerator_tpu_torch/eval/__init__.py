"""Quality evaluation: CLIPScore and the CLIP-Fréchet distance —
counterpart of ``imagegenerator_tpu/eval/``.

* ``frechet.FeatureMoments`` / ``frechet.frechet_distance``: the Gaussian
  fit of a feature set and the Fréchet distance, host float64.
* ``clip_eval.image_embeddings`` / ``text_embeddings`` / ``clip_score``:
  a CLIP tower as the feature extractor, on the card.
* ``cli.main``: ``python -m imagegenerator_tpu_torch.eval.cli``.
"""

from imagegenerator_tpu_torch.eval.clip_eval import (  # noqa: F401
    clip_score,
    image_embeddings,
    text_embeddings,
)
from imagegenerator_tpu_torch.eval.frechet import (  # noqa: F401
    FeatureMoments,
    frechet_distance,
    gaussian_stats,
)
