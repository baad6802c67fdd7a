"""The port's attribution tail against the JAX package's, on one 2-layer
k=16 model trained by the port's CLI on the CPU that both packages load:
hotspot maps (``hotspot`` functions and CLI), constrained attribution,
PDB site scoring (``process_pdb``; the reference's merged sites), the
PyMOL-free half of the session rendering and the GROMACS/MD correlation
tools.

The receptor of the model-running tests is the 7zzp receptor cut to its
atoms within 6 A of the 7zzp ligand (the hotspot and constrained CLIs
box 12 A around each ligand, so the whole cut), the fragments the ligand
and one seeded rigid copy of it (rotated up to 10 degrees, shifted up to
0.5 A). Each JAX CLI runs once in the module. Scores are held within
2e-5 (``MASK_TOL``, as in ``test_torch_attribution_driver.py``),
positions, types and classes equal, SDF and PDB outputs line for line.
"""
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from pointvs_tpu_torch.main import main as port_main
from tests.setup_and_params import RESOURCES

MASK_TOL = 2e-5
REC_7ZZP = RESOURCES / '7zzp_rec_0.pdb'
LIG_7ZZP = RESOURCES / '7zzp_lig_0.sdf'
POCKET_RADIUS = 6.0
SEED = 14


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """A 2-layer model trained 1 epoch by the port's CLI (with node and
    softmax edge attention), which both packages load."""
    root = tmp_path_factory.mktemp('tail_run') / 'run'
    port_main(['egnn', str(root), '--train_data_root_pose', str(RESOURCES),
               '--train_types_pose', str(RESOURCES / 'test.types'),
               '--layers', '2', '-k', '16', '-ep', '1', '-b', '2',
               '--compact', '--egnn_attention', '--node_attention',
               '--softmax_attention', '--prefetch', '0', '--device', 'cpu'])
    return root


def _sdf_coords(path):
    lines = Path(path).read_text().splitlines()
    n_atoms = int(lines[3][:3])
    return lines, np.array([[float(line[c:c + 10]) for c in (0, 10, 20)]
                            for line in lines[4:4 + n_atoms]])


def write_rigid_copy(src, dst, rng, max_deg=10.0, max_shift=0.5):
    """``src`` (an SDF) rotated by up to ``max_deg`` about its centroid
    and shifted by up to ``max_shift`` A, its atom block rewritten."""
    lines, xyz = _sdf_coords(src)
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    theta = np.deg2rad(rng.uniform(0, max_deg))
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx
    shift = rng.uniform(-1, 1, 3)
    shift *= rng.uniform(0, max_shift) / np.linalg.norm(shift)
    centre = xyz.mean(0)
    new = (xyz - centre) @ rot.T + centre + shift
    for i, (x, y, z) in enumerate(new):
        line = lines[4 + i]
        lines[4 + i] = f'{x:10.4f}{y:10.4f}{z:10.4f}{line[30:]}'
    Path(dst).write_text('\n'.join(lines) + '\n')
    return dst


def write_pocket_pdb(dst, radius=POCKET_RADIUS):
    """The 7zzp receptor's ATOM records within ``radius`` of its
    ligand's atoms."""
    lig = _sdf_coords(LIG_7ZZP)[1]
    kept = []
    for line in REC_7ZZP.read_text().splitlines():
        if line.startswith('ATOM'):
            xyz = np.array([float(line[c:c + 8]) for c in (30, 38, 46)])
            if np.sqrt(((lig - xyz) ** 2).sum(1)).min() < radius:
                kept.append(line)
    Path(dst).write_text('\n'.join(kept + ['END']) + '\n')
    return dst


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """(cut receptor PDB, [the ligand, its rigid copy])."""
    root = tmp_path_factory.mktemp('tail_inputs')
    rng = np.random.default_rng(SEED)
    pocket = write_pocket_pdb(root / 'pocket.pdb')
    frags = [LIG_7ZZP, write_rigid_copy(LIG_7ZZP, root / 'frag_1.sdf', rng)]
    return pocket, frags


def _assert_csv_close(got, want, score_cols, tol=MASK_TOL):
    """Equal columns and rows; ``score_cols`` within ``tol``, the rest
    equal, compared row by row after sorting both by position (rows whose
    scores nearly tie may come in either order)."""
    g = got if isinstance(got, pd.DataFrame) else pd.read_csv(got)
    w = want if isinstance(want, pd.DataFrame) else pd.read_csv(want)
    assert list(g.columns) == list(w.columns) and len(g) == len(w)
    for col in score_cols:   # each side sorted best first
        np.testing.assert_allclose(g[col], w[col], atol=tol, rtol=0)
    key = ['x', 'y', 'z']
    g = g.sort_values(key, kind='mergesort').reset_index(drop=True)
    w = w.sort_values(key, kind='mergesort').reset_index(drop=True)
    for col in w.columns:
        if col in score_cols:
            np.testing.assert_allclose(g[col], w[col], atol=tol, rtol=0)
        elif col != 'rank':
            np.testing.assert_array_equal(g[col], w[col], err_msg=col)


@pytest.fixture(scope='module')
def hotspots(run, inputs, tmp_path_factory):
    """Both hotspot CLIs on the cut receptor and the two fragments, the
    cut receptor as the apo structure: (port dir, JAX dir, port ranks)."""
    from pointvs_tpu.attribution.hotspot import main as jax_main
    from pointvs_tpu_torch.attribution.hotspot import main
    pocket, frags = inputs
    root = tmp_path_factory.mktemp('hotspots')
    args = [str(run), str(pocket)] + [str(f) for f in frags] + [
        '--apo_protein', str(pocket), '--top_n', '12']
    jax_main(args + ['-o', str(root / 'jax')])
    ranks = main(args + ['-o', str(root / 'port'), '--device', 'cpu'])
    return root / 'port', root / 'jax', ranks


def test_hotspot_cli_matches_jax(hotspots):
    port, jax_dir, ranks = hotspots
    assert (ranks.n_complexes == 2).sum() > 12
    assert list(ranks['rank']) == list(range(1, len(ranks) + 1))
    _assert_csv_close(port / 'hotspot_ranks.csv',
                      jax_dir / 'hotspot_ranks.csv', ['mean_attribution'])
    _assert_csv_close(port / 'pharmacophores.csv',
                      jax_dir / 'pharmacophores.csv', ['mean_attribution'])
    typed = pd.read_csv(port / 'typed_pharmacophores.csv')
    assert np.isfinite(typed.score).sum() == len(ranks)
    # The parser types the pocket's nitrogens DonorAcceptor, which only a
    # ligand pharmacophore resolves: no 'hbd' without one, in both.
    assert set(typed.pharmacophore) == {'hba', 'none'}
    _assert_csv_close(port / 'typed_pharmacophores.csv',
                      jax_dir / 'typed_pharmacophores.csv', ['score'])
    # Every top-12 and top-7 score is more than the gate from its
    # neighbours here, so the SDFs' rows come in one order.
    for name, atoms in (('hotspots.sdf', 12), ('hba.sdf', 7),
                        ('hbd.sdf', 0)):
        got = (port / name).read_text().splitlines()
        assert got == (jax_dir / name).read_text().splitlines(), name
        assert int(got[3][:3]) == atoms, name


def test_hotspot_functions_match_jax(hotspots, inputs):
    """``hotspot_pharmacophores`` and ``scores_to_pharmacophore_df`` on
    the same rank frame, also with ranks for scores (``use_rank``) and
    ligand pharmacophores that resolve the ambiguous types."""
    from pointvs_tpu.attribution import hotspot as jax_hotspot
    from pointvs_tpu_torch.attribution import hotspot
    _, _, ranks = hotspots
    pocket = inputs[0]
    ranks = ranks.assign(lig_pharm=np.resize(['hba', 'hbd', 'none'],
                                             len(ranks)))
    for kwargs in ({'top_n': 5}, {'top_n': 50, 'min_complexes': 1}):
        pd.testing.assert_frame_equal(
            hotspot.hotspot_pharmacophores(ranks, **kwargs),
            jax_hotspot.hotspot_pharmacophores(ranks, **kwargs))
    for use_rank in (False, True):
        frame = ranks.assign(mean_attribution=ranks['rank'].astype(float)) \
            if use_rank else ranks
        got = hotspot.scores_to_pharmacophore_df(pocket, frame, use_rank)
        want = jax_hotspot.scores_to_pharmacophore_df(pocket, frame,
                                                      use_rank)
        pd.testing.assert_frame_equal(got, want)
        assert got.pharmacophore.isin(['hba', 'hbd']).sum() > 5
    for smina_type in set(got.smina_type) | {'Sulfur', 'Oxygen'}:
        for lig_pharm in ('hba', 'hbd', 'none'):
            assert hotspot.pharmacophore_from_smina_type(
                smina_type, lig_pharm) == \
                jax_hotspot.pharmacophore_from_smina_type(smina_type,
                                                          lig_pharm)


def test_pharmacophore_mols_need_rdkit_in_both(hotspots):
    from pointvs_tpu.attribution.hotspot import \
        pharmacophore_df_to_mols as jax_to_mols
    from pointvs_tpu_torch.attribution.hotspot import \
        pharmacophore_df_to_mols
    typed = pd.read_csv(hotspots[0] / 'typed_pharmacophores.csv')
    for fn in (pharmacophore_df_to_mols, jax_to_mols):
        try:
            import rdkit  # noqa: F401
        except ImportError:
            with pytest.raises(ImportError):
                fn(typed, cutoff=7)
        else:
            hba, hbd = fn(typed, cutoff=7)
            assert hba.GetNumAtoms() + hbd.GetNumAtoms() > 0


def test_constrained_attribution_matches_jax(run, inputs, tmp_path):
    from pointvs_tpu.attribution.constrained_attribution import \
        main as jax_main
    from pointvs_tpu_torch.attribution.constrained_attribution import main
    pocket, frags = inputs
    args = [str(run), str(pocket)] + [str(f) for f in frags] + [
        '--core_ligand', str(LIG_7ZZP)]
    jax_main(args + ['-o', str(tmp_path / 'jax')])
    got = main(args + ['-o', str(tmp_path / 'port'), '--device', 'cpu'])
    want = pd.read_csv(tmp_path / 'jax' / 'constrained_scores.csv')
    assert len(got) == 18 and (got.bp == 0).all()
    assert (got.core_distance[:9] == 0).all()
    assert got.core_distance[9:].max() > 0.1
    assert (tmp_path / 'port' / 'distance_vs_score.png').exists()
    g = pd.read_csv(tmp_path / 'port' / 'constrained_scores.csv')
    assert list(g.columns) == list(want.columns)
    np.testing.assert_allclose(g.attribution, want.attribution,
                               atol=MASK_TOL, rtol=0)
    np.testing.assert_allclose(g.core_distance, want.core_distance,
                               atol=1e-6, rtol=0)
    for col in ('x', 'y', 'z', 'atomic_number', 'types', 'bp'):
        np.testing.assert_array_equal(g[col], want[col], err_msg=col)
    assert [Path(p).name for p in g.ligand] == \
        [Path(p).name for p in want.ligand]


def test_distance_to_core_and_mcs_gate():
    from pointvs_tpu.attribution import constrained_attribution as jax_ca
    from pointvs_tpu_torch.attribution import constrained_attribution as ca
    rng = np.random.default_rng(SEED)
    scored = pd.DataFrame(rng.normal(size=(12, 3)) * 3,
                          columns=['x', 'y', 'z']).assign(
        bp=rng.integers(0, 2, 12), attribution=rng.normal(size=12))
    core = rng.normal(size=(4, 3))
    pd.testing.assert_frame_equal(ca.distance_to_core(scored, core),
                                  jax_ca.distance_to_core(scored, core))
    np.testing.assert_array_equal(ca.core_ligand_coords(LIG_7ZZP).shape,
                                  (9, 3))
    try:
        import rdkit  # noqa: F401
    except ImportError:
        for fn in (ca.mcs_core_coords, jax_ca.mcs_core_coords):
            with pytest.raises(ImportError):
                fn([LIG_7ZZP])


def _residue_heavy_atoms(resn, chain, resi):
    return sum(1 for line in REC_7ZZP.read_text().splitlines()
               if line.startswith('HETATM') and line[17:20] == resn
               and line[21] == chain and line[22:26].strip() == resi
               and line[76:78].strip() != 'H')


def test_ligand_sites_merge_copies_like_jax():
    """The reference collects a site's atoms by residue name alone, so
    the three 2OP copies each get all 18 heavy atoms where one has 6; the
    port's sites equal JAX's (ids, atom counts and coordinates)."""
    from pointvs_tpu.attribution.process_pdb import \
        find_ligand_sites as jax_sites
    from pointvs_tpu_torch.attribution.process_pdb import find_ligand_sites
    got, want = find_ligand_sites(REC_7ZZP), jax_sites(REC_7ZZP)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (site, g), (_, w) in zip(got, want):
        pd.testing.assert_frame_equal(g, w, check_dtype=False, obj=site)
    sites = dict(got)
    assert _residue_heavy_atoms('2OP', 'A', '612') == 6
    assert len(sites['2OP:A:612']) == 18
    assert len(sites['PG4:B:607']) == 26
    assert len(sites['NHE:B:614']) == 13
    np.testing.assert_array_equal(sites['2OP:A:612'],
                                  sites['2OP:C:609'])


@pytest.fixture(scope='module')
def nhe_site(run, tmp_path_factory):
    """``score_and_colour_pdb`` on the NHE site (radius 6, edges 4) in
    both packages, and the JAX package's ``score_atoms`` on the site's
    parquet and its own parse of the receptor written as a parquet (the
    path the reference's ``score_pdb`` means to take): (port dir, JAX
    dir, JAX's outputs, JAX's site frame)."""
    import torch
    from pointvs_tpu.attribution.attribution import \
        colour_b_factors_pdb as jax_colour
    from pointvs_tpu.attribution.attribution import score_atoms as jax_atoms
    from pointvs_tpu.attribution.attribution_fns import \
        ATTRIBUTION_FNS as JAX_FNS
    from pointvs_tpu.attribution.process_pdb import \
        score_and_colour_pdb as jax_score
    from pointvs_tpu.dataset_generation.types_to_parquet import \
        StructuralFileParser as JaxParser
    from pointvs_tpu.models.load_model import load_model as jax_load
    from pointvs_tpu_torch.attribution.attribution_fns import ATTRIBUTION_FNS
    from pointvs_tpu_torch.attribution.process_pdb import \
        score_and_colour_pdb
    from pointvs_tpu_torch.models.load_model import load_model
    root = tmp_path_factory.mktemp('nhe')
    kwargs = dict(radius=POCKET_RADIUS, edge_radius=4)
    jax_trainer = jax_load(run)[0]
    outputs = jax_score(jax_trainer, JAX_FNS['atom_masking'], REC_7ZZP,
                        root / 'jax', only_process='NHE', **kwargs)
    rec_parquet = root / 'rec.parquet'
    JaxParser('receptor').file_to_parquets(REC_7ZZP).to_parquet(rec_parquet)
    want = jax_atoms(jax_trainer, rec_parquet, root / 'jax' /
                     'NHE_B_614.parquet', JAX_FNS['atom_masking'], **kwargs)
    jax_colour(REC_7ZZP, root / 'jax' / 'NHE_B_614_scored.pdb', want)
    got = score_and_colour_pdb(
        load_model(run, torch.device('cpu'))[0],
        ATTRIBUTION_FNS['atom_masking'], REC_7ZZP, root / 'port',
        only_process='NHE', **kwargs)
    assert list(got) == ['NHE:B:614']
    return root / 'port', root / 'jax', outputs, want


def test_reference_scores_no_pdb_site(nhe_site):
    """The reference's ``score_pdb`` writes each site as a parquet, and
    its ``score_atoms`` then parses both inputs as structure files, which
    refuses a parquet: the site is logged and skipped, nothing written.
    The port reads each input by its suffix and scores the site."""
    port, jax_dir, outputs, _ = nhe_site
    assert outputs == {}
    assert not list(jax_dir.glob('*_scores.csv'))
    assert (jax_dir / 'NHE_B_614.parquet').read_bytes() == \
        (port / 'NHE_B_614.parquet').read_bytes()


def test_score_and_colour_pdb_matches_jax(nhe_site):
    port, jax_dir, _, want = nhe_site
    got = pd.read_csv(port / 'NHE_B_614_scores.csv')
    assert (got.bp == 0).sum() == 13 and len(got) > 30
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.attribution, want.attribution,
                               atol=MASK_TOL, rtol=0)
    for col in ('x', 'y', 'z', 'atomic_number', 'types', 'bp'):
        np.testing.assert_array_equal(got[col], want[col], err_msg=col)
    got_pdb, want_pdb = [(d / 'NHE_B_614_scored.pdb').read_text()
                         .splitlines() for d in (port, jax_dir)]
    assert got_pdb == want_pdb
    assert got_pdb != REC_7ZZP.read_text().splitlines()
    assert not list(port.glob('*.pse'))     # no PyMOL here


def test_bond_map_and_cgo_objects_match_jax(nhe_site):
    from pointvs_tpu.attribution import plip_subclasses as jax_plip
    from pointvs_tpu.attribution import process_pdb as jax_pp
    from pointvs_tpu_torch.attribution import plip_subclasses as plip
    from pointvs_tpu_torch.attribution import process_pdb as pp
    scored = pd.read_csv(nhe_site[0] / 'NHE_B_614_scores.csv')
    assert pp._bfactor_map(scored) == jax_pp._bfactor_map(scored)
    for top_n, max_dist in ((5, 4.0), (13, 6.0)):
        bonds = pp._top_bond_map(scored, top_n, max_dist)
        assert bonds == jax_pp._top_bond_map(scored, top_n, max_dist)
        assert bonds
        for inverse in (False, True):
            assert plip.hbond_cgo_objects(bonds, inverse) == \
                jax_plip.hbond_cgo_objects(bonds, inverse)
    interp = plip.get_colour_interpolation_fn([0, 0, 0], [1, .5, 1], -1, 3)
    want = jax_plip.get_colour_interpolation_fn([0, 0, 0], [1, .5, 1], -1, 3)
    for val in (-2, -1, 0.3, 3, 7):
        assert interp(val) == want(val)
    assert plip.CYLINDER == jax_plip.CYLINDER
    assert not plip.render_attribution_pse('x.pdb', 'x.pse')


GRO = ('MD frame\n'
       '    6\n'
       '    1MOL     C1    1   0.100   0.200   0.300\n'
       '    1MOL     N1    2   0.400   0.500   0.600\n'
       '    2HOH     OW    3   1.000   1.000   1.000\n'
       '    3ALA     CA    4   0.700   0.800   0.900\n'
       '    3ALA     CL    5   0.710   0.810   0.910\n'
       '    4NA      NA    6   1.500   1.500   1.500\n'
       '   2.0 2.0 2.0\n')


def write_md_files(root, seed=SEED):
    """A .gro frame, an .xvg of 5 bond distances over 40 frames, an
    hbond.ndx and a bond-score CSV (4 of the 5 bonds), from the seed."""
    rng = np.random.default_rng(seed)
    (root / 'frame.gro').write_text(GRO)
    rows = np.column_stack([np.arange(40) * 10.0,
                            rng.uniform(0.25, 0.45, (40, 5))])
    (root / 'hbnum.xvg').write_text(
        '# gmx hbond\n@    title "Hydrogen Bonds"\n@ s0 legend "x"\n'
        + ''.join(' '.join(f'{v:.4f}' for v in row) + '\n' for row in rows))
    (root / 'hbond.ndx').write_text(
        '[ donors_hydrogens_MOL ]\n 1 2\n[ acceptors_ALA ]\n 4 5 6\n'
        '[ hbonds_MOL-ALA ]\n 1 2 4\n 3 4 5\n\n[ other ]\n 7 8 9\n')
    pd.DataFrame({'bond': [f'value_{i}' for i in range(4)],
                  'score': rng.normal(size=4)}).to_csv(
        root / 'scores.csv', index=False)


def test_gromacs_functions_match_jax(tmp_path):
    from pointvs_tpu.attribution import gromacs as jax_gmx
    from pointvs_tpu_torch.attribution import gromacs as gmx
    write_md_files(tmp_path)
    xvg = gmx.parse_xvg(tmp_path / 'hbnum.xvg')
    pd.testing.assert_frame_equal(xvg, jax_gmx.parse_xvg(
        tmp_path / 'hbnum.xvg'))
    assert xvg.shape == (40, 6)
    assert gmx.parse_hbond_ndx(tmp_path / 'hbond.ndx') == \
        jax_gmx.parse_hbond_ndx(tmp_path / 'hbond.ndx') == \
        [(1, 2, 4), (3, 4, 5)]
    stats = gmx.bond_distance_stats(xvg)
    pd.testing.assert_frame_equal(stats, jax_gmx.bond_distance_stats(xvg))
    scores = pd.read_csv(tmp_path / 'scores.csv')
    rho = gmx.correlate_md_with_attribution(stats, scores)
    assert rho == jax_gmx.correlate_md_with_attribution(stats, scores)
    assert np.isfinite(rho[0])
    assert np.isnan(gmx.correlate_md_with_attribution(
        stats, scores[:2])[0])
    for name, package in (('port', gmx), ('jax', jax_gmx)):
        package.gro_to_pdb(tmp_path / 'frame.gro', tmp_path / f'{name}.pdb')
        package.remove_solvent_pdb(tmp_path / f'{name}.pdb')
    assert (tmp_path / 'port.pdb').read_text() == \
        (tmp_path / 'jax.pdb').read_text()
    assert 'HOH' not in (tmp_path / 'port.pdb').read_text()
    ids = gmx.parse_gromacs_file(tmp_path / 'frame.gro')
    assert ids == jax_gmx.parse_gromacs_file(tmp_path / 'frame.gro')
    assert ids[(7.0, 8.0, 9.0)] == '3:ALA:CA'
    bad = tmp_path / 'bad.gro'
    bad.write_text(GRO.replace('CL    5', 'CA    5'))
    for package in (gmx, jax_gmx):
        with pytest.raises(RuntimeError, match='unique mapping'):
            package.parse_gromacs_file(bad)


def test_gromacs_tools_without_gmx_or_pymol(tmp_path, monkeypatch):
    import shutil
    from pointvs_tpu_torch.attribution import gromacs as gmx
    from pointvs_tpu_torch.utils import execute_cmd
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    with pytest.raises(SystemExit, match='gmx'):
        gmx.run_gmx_hbond('a.tpr', 'a.xtc', tmp_path)
    with pytest.raises(SystemExit, match='PyMOL'):
        gmx.make_pymol_movie(['a.pdb'], tmp_path / 'a.mpg')
    bad = tmp_path / 'bad.gro'
    bad.write_text('title\nnot a count\n')
    with pytest.raises(ValueError):
        gmx.gro_to_pdb(bad, tmp_path / 'bad.pdb')
    assert execute_cmd('echo hi', silent=True).stdout == b'hi\n'
    with pytest.raises(Exception, match='returned non-zero|exit status'):
        execute_cmd('echo oops >&2; exit 3')


def test_md_clis_match_jax(tmp_path):
    from pointvs_tpu.attribution.gromacs import main as jax_gmx_main
    from pointvs_tpu.attribution.md_gnn_correlation import \
        main as jax_md_main
    from pointvs_tpu_torch.attribution.gromacs import main as gmx_main
    from pointvs_tpu_torch.attribution.md_gnn_correlation import \
        main as md_main
    write_md_files(tmp_path)
    args = [str(tmp_path / 'hbnum.xvg'), str(tmp_path / 'scores.csv')]
    gro = ['--gro_file', str(tmp_path / 'frame.gro')]
    jax_gmx_main(args + gro + ['-o', str(tmp_path / 'jax')])
    rho = gmx_main(args + gro + ['-o', str(tmp_path / 'port')])
    for name in ('bond_stats.csv', 'gro_atom_ids.csv', 'frame.pdb'):
        assert (tmp_path / 'port' / name).read_text() == \
            (tmp_path / 'jax' / name).read_text(), name
    jax_md_main(args + ['-o', str(tmp_path / 'jax_md')])
    assert md_main(args + ['-o', str(tmp_path / 'port_md')]) == rho
    assert (tmp_path / 'port_md' / 'md_gnn_correlation.png').exists()
    assert (tmp_path / 'jax_md' / 'md_gnn_correlation.png').exists()
