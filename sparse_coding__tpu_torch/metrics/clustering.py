"""Dictionary-vector clustering diagnostics (host-side sklearn/scipy).

Counterpart of `sparse_coding__tpu/metrics/clustering.py`: t-SNE + KMeans
cluster listing and hierarchical (cosine-linkage) clustering. Offline
analysis on the host: a dictionary's rows come to the host as numpy, the
cluster ids are numpy. sklearn and scipy are imported when called (the
card's machine has no sklearn).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cluster_vectors(
    model,
    n_clusters: int = 1000,
    top_clusters: int = 10,
    save_loc: Optional[str] = None,
    random_state: int = 0,
    perplexity: float = 30.0,
) -> List[np.ndarray]:
    """t-SNE → KMeans on the dictionary rows; returns the member indices of
    the `top_clusters` most populous clusters."""
    from sklearn.cluster import KMeans
    from sklearn.manifold import TSNE

    vectors = _host(model.get_learned_dict())
    perplexity = min(perplexity, max(2.0, (vectors.shape[0] - 1) / 3))
    tsne = TSNE(n_components=2, random_state=random_state, perplexity=perplexity)
    embedded = tsne.fit_transform(vectors)
    n_clusters = min(n_clusters, vectors.shape[0])
    kmeans = KMeans(n_clusters=n_clusters, random_state=random_state, n_init=10).fit(embedded)
    ids, counts = np.unique(kmeans.labels_, return_counts=True)
    order = np.argsort(counts)[::-1]
    top = [np.where(kmeans.labels_ == ids[i])[0] for i in order[:top_clusters]]
    if save_loc:
        with open(save_loc, "w") as f:
            for cluster in top:
                f.write(f"{list(cluster)}\n")
    return top


def hierarchical_cluster_vectors(vectors, n_clusters: int = 100) -> np.ndarray:
    """Average-linkage cosine hierarchical clustering; returns cluster ids per
    row (``vectors`` a tensor or an array)."""
    from scipy.cluster.hierarchy import cut_tree, linkage

    linkage_matrix = linkage(_host(vectors), "average", metric="cosine")
    return cut_tree(linkage_matrix, n_clusters=n_clusters).reshape(-1)
