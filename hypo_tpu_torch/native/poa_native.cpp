// Copied from hypo_tpu/native/poa_native.cpp.
// Native POA engine for hypo_tpu.
//
// A C++ implementation of the same POA semantics as hypo_tpu/poa/
// (graph.py + align.py + engine.py), written fresh against that verified
// Python oracle.  Semantics match the reference's adapted spoa behavior
// (see reference external/spoa/src/graph.cpp, sisd_alignment_engine.cpp)
// including traceback and heaviest-bundle tie rules.  Exposed as a C API
// consumed via ctypes (hypo_tpu/native/api.py).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC poa_native.cpp -o libhypo_poa.so

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int32_t NEG = -(1 << 30);

enum Mode { MODE_NW = 0, MODE_LOV = 1, MODE_ROV = 2 };

struct Edge {
    int begin;
    int end;
    long long total_weight;
    std::vector<int> labels;
};

struct Node {
    int code;
    std::vector<int> in_edges;   // edge pool indices
    std::vector<int> out_edges;
    std::vector<int> aligned;    // aligned node ids
};

struct Graph {
    int num_sequences = 0;
    int num_codes = 0;
    std::array<int, 256> coder;
    std::vector<char> decoder;
    std::vector<Node> nodes;
    std::vector<Edge> edges;
    std::vector<int> rank_to_node_id;
    std::vector<int> seq_begin;
    std::vector<int> consensus_ids;

    Graph() { coder.fill(-1); }

    int add_node(int code) {
        nodes.push_back(Node{code, {}, {}, {}});
        return (int)nodes.size() - 1;
    }

    void add_edge(int begin, int end, long long weight) {
        for (int ei : nodes[begin].out_edges) {
            if (edges[ei].end == end) {
                edges[ei].labels.push_back(num_sequences);
                edges[ei].total_weight += weight;
                return;
            }
        }
        edges.push_back(Edge{begin, end, weight, {num_sequences}});
        int ei = (int)edges.size() - 1;
        nodes[begin].out_edges.push_back(ei);
        nodes[end].in_edges.push_back(ei);
    }

    int add_stretch(const char* seq, int begin, int end, int weight) {
        if (begin == end) return -1;
        int first = add_node(coder[(unsigned char)seq[begin]]);
        for (int i = begin + 1; i < end; ++i) {
            int nid = add_node(coder[(unsigned char)seq[i]]);
            add_edge(nid - 1, nid, 2LL * weight);
        }
        return first;
    }

    // PROVENANCE: like traverse_heaviest_bundle below, this DFS with
    // aligned-group hoisting closely follows the reference's spoa
    // graph.cpp:293-353 by necessity — the bit-parity goal requires
    // the exact rank order it emits (a node's whole aligned group is
    // appended when its first member finalizes, in aligned-id order),
    // which downstream tie-breaking depends on.
    void topological_sort() {
        rank_to_node_id.clear();
        int n = (int)nodes.size();
        std::vector<uint8_t> marks(n, 0);
        std::vector<uint8_t> check_aligned(n, 1);
        std::vector<int> stack;
        for (int i = 0; i < n; ++i) {
            if (marks[i] != 0) continue;
            stack.push_back(i);
            while (!stack.empty()) {
                int nid = stack.back();
                bool valid = true;
                if (marks[nid] != 2) {
                    for (int ei : nodes[nid].in_edges) {
                        int b = edges[ei].begin;
                        if (marks[b] != 2) {
                            stack.push_back(b);
                            valid = false;
                        }
                    }
                    if (check_aligned[nid]) {
                        for (int aid : nodes[nid].aligned) {
                            if (marks[aid] != 2) {
                                stack.push_back(aid);
                                check_aligned[aid] = 0;
                                valid = false;
                            }
                        }
                    }
                    if (valid) {
                        marks[nid] = 2;
                        if (check_aligned[nid]) {
                            rank_to_node_id.push_back(nid);
                            for (int aid : nodes[nid].aligned)
                                rank_to_node_id.push_back(aid);
                        }
                    } else {
                        marks[nid] = 1;
                    }
                }
                if (valid) stack.pop_back();
            }
        }
    }

    // alignment: pairs (node_id|-1, seq_idx|-1)
    // PROVENANCE: the node-fusion walk (match-to-node vs match-to-
    // aligned-twin vs new-node-joining-the-aligned-group, head/tail
    // stretch handling, begin/prev edge weaving) closely follows the
    // reference's spoa graph.cpp:154-271 by necessity — bit-parity
    // requires its exact group-membership and edge-weight semantics.
    // The flat edge pool and rank arrays around it are this repo's own.
    void add_alignment(const int32_t* anode, const int32_t* aseq,
                       int alen, const char* seq, int slen,
                       int weight = 1) {
        if (slen == 0) return;
        for (int i = 0; i < slen; ++i) {
            unsigned char c = (unsigned char)seq[i];
            if (coder[c] == -1) {
                coder[c] = num_codes;
                decoder.push_back((char)c);
                ++num_codes;
            }
        }
        if (alen == 0) {
            int begin_id = add_stretch(seq, 0, slen, weight);
            ++num_sequences;
            seq_begin.push_back(begin_id);
            topological_sort();
            return;
        }
        int first_valid = -1, last_valid = -1;
        for (int i = 0; i < alen; ++i) {
            if (aseq[i] != -1) {
                if (first_valid < 0) first_valid = aseq[i];
                last_valid = aseq[i];
            }
        }
        size_t tmp = nodes.size();
        int begin_id = add_stretch(seq, 0, first_valid, weight);
        int head_id = (tmp == nodes.size()) ? -1 : (int)nodes.size() - 1;
        int tail_id = add_stretch(seq, last_valid + 1, slen, weight);

        int new_id = -1;
        long long prev_weight = (head_id == -1) ? 0 : weight;
        for (int i = 0; i < alen; ++i) {
            if (aseq[i] == -1) continue;
            char letter = seq[aseq[i]];
            if (anode[i] == -1) {
                new_id = add_node(coder[(unsigned char)letter]);
            } else {
                Node& nd = nodes[anode[i]];
                if (decoder[nd.code] == letter) {
                    new_id = anode[i];
                } else {
                    int aligned_to = -1;
                    for (int aid : nd.aligned) {
                        if (decoder[nodes[aid].code] == letter) {
                            aligned_to = aid;
                            break;
                        }
                    }
                    if (aligned_to == -1) {
                        new_id = add_node(coder[(unsigned char)letter]);
                        for (int aid : nodes[anode[i]].aligned) {
                            nodes[new_id].aligned.push_back(aid);
                            nodes[aid].aligned.push_back(new_id);
                        }
                        nodes[new_id].aligned.push_back(anode[i]);
                        nodes[anode[i]].aligned.push_back(new_id);
                    } else {
                        new_id = aligned_to;
                    }
                }
            }
            if (begin_id == -1) begin_id = new_id;
            if (head_id != -1)
                add_edge(head_id, new_id, prev_weight + weight);
            head_id = new_id;
            prev_weight = weight;
        }
        if (tail_id != -1)
            add_edge(head_id, tail_id, prev_weight + weight);
        ++num_sequences;
        seq_begin.push_back(begin_id);
        topological_sort();
    }

    // ------- DP align (linear), modes NW/LOV/ROV; same tie rules -------
    void align(const char* seq, int slen, int mode, int m, int n, int g,
               std::vector<int32_t>& out_nodes,
               std::vector<int32_t>& out_seq) const {
        out_nodes.clear();
        out_seq.clear();
        if (nodes.empty() || slen == 0) return;
        int nn = (int)nodes.size();
        int width = slen + 1;
        std::vector<int> rank_of(nn, 0);
        for (int r = 0; r < nn; ++r) rank_of[rank_to_node_id[r]] = r;
        std::vector<int32_t> H((size_t)(nn + 1) * width);
        // row 0
        for (int j = 0; j < width; ++j) H[j] = j * g;
        // column 0
        if (mode == MODE_NW || mode == MODE_LOV) {
            for (int r = 0; r < nn; ++r) {
                const Node& node = nodes[rank_to_node_id[r]];
                int32_t penalty = NEG;
                if (node.in_edges.empty()) {
                    penalty = 0;
                } else {
                    for (int ei : node.in_edges) {
                        int pr = rank_of[edges[ei].begin] + 1;
                        penalty = std::max(penalty,
                                           H[(size_t)pr * width]);
                    }
                }
                H[(size_t)(r + 1) * width] = penalty + g;
            }
        } else {
            for (int r = 0; r < nn; ++r) H[(size_t)(r + 1) * width] = 0;
        }

        int32_t max_score = NEG;
        int max_i = -1, max_j = -1;
        std::vector<int> preds;
        for (int rr = 0; rr < nn; ++rr) {
            int nid = rank_to_node_id[rr];
            const Node& node = nodes[nid];
            int i = rr + 1;
            int32_t* Hrow = &H[(size_t)i * width];
            preds.clear();
            if (node.in_edges.empty()) {
                preds.push_back(0);
            } else {
                for (int ei : node.in_edges)
                    preds.push_back(rank_of[edges[ei].begin] + 1);
            }
            char dc = decoder[node.code];
            {
                const int32_t* Hp = &H[(size_t)preds[0] * width];
                for (int j = 1; j < width; ++j) {
                    int32_t sub = (seq[j - 1] == dc) ? m : n;
                    Hrow[j] = std::max(Hp[j - 1] + sub, Hp[j] + g);
                }
                for (size_t p = 1; p < preds.size(); ++p) {
                    const int32_t* Hq = &H[(size_t)preds[p] * width];
                    for (int j = 1; j < width; ++j) {
                        int32_t sub = (seq[j - 1] == dc) ? m : n;
                        int32_t v = std::max(Hq[j - 1] + sub, Hq[j] + g);
                        if (v > Hrow[j]) Hrow[j] = v;
                    }
                }
            }
            bool is_end = node.out_edges.empty();
            for (int j = 1; j < width; ++j) {
                Hrow[j] = std::max(Hrow[j - 1] + g, Hrow[j]);
                bool elig =
                    (mode == MODE_LOV && j == width - 1) ||
                    ((mode == MODE_NW || mode == MODE_ROV) &&
                     j == width - 1 && is_end);
                if (elig && max_score < Hrow[j]) {
                    max_score = Hrow[j];
                    max_i = i;
                    max_j = j;
                }
            }
        }

        // traceback
        int i = std::max(0, max_i), j = std::max(0, max_j);
        auto keep_going = [&]() {
            if (mode == MODE_ROV) return !(i == 0 || j == 0);
            return !(i == 0 && j == 0);
        };
        while (keep_going()) {
            int32_t h_ij = H[(size_t)i * width + j];
            int prev_i = 0, prev_j = 0;
            bool found = false;
            if (i != 0 && j != 0) {
                const Node& node = nodes[rank_to_node_id[i - 1]];
                char dc = decoder[node.code];
                int32_t match_cost = (seq[j - 1] == dc) ? m : n;
                if (node.in_edges.empty()) {
                    if (h_ij == H[j - 1] + match_cost) {
                        prev_i = 0; prev_j = j - 1; found = true;
                    }
                } else {
                    for (int ei : node.in_edges) {
                        int p = rank_of[edges[ei].begin] + 1;
                        if (h_ij ==
                            H[(size_t)p * width + j - 1] + match_cost) {
                            prev_i = p; prev_j = j - 1; found = true;
                            break;
                        }
                    }
                }
            }
            if (!found && i != 0) {
                const Node& node = nodes[rank_to_node_id[i - 1]];
                if (node.in_edges.empty()) {
                    if (h_ij == H[j] + g) {
                        prev_i = 0; prev_j = j; found = true;
                    }
                } else {
                    for (int ei : node.in_edges) {
                        int p = rank_of[edges[ei].begin] + 1;
                        if (h_ij == H[(size_t)p * width + j] + g) {
                            prev_i = p; prev_j = j; found = true;
                            break;
                        }
                    }
                }
            }
            if (!found && h_ij == H[(size_t)i * width + j - 1] + g) {
                prev_i = i; prev_j = j - 1; found = true;
            }
            out_nodes.push_back(i == prev_i ? -1
                                            : rank_to_node_id[i - 1]);
            out_seq.push_back(j == prev_j ? -1 : j - 1);
            i = prev_i;
            j = prev_j;
        }
        std::reverse(out_nodes.begin(), out_nodes.end());
        std::reverse(out_seq.begin(), out_seq.end());
    }

    // ------- heaviest bundle consensus ---------------------------------
    // PROVENANCE: traverse_heaviest_bundle/branch_completion closely
    // follow the reference's spoa graph.cpp:610-705 by necessity — the
    // bit-parity goal requires replicating its exact tie-breaking
    // (max (weight, pred score) with later-edge ties, the node-0 reset
    // in branch completion, suffix-only re-relaxation).  The
    // surrounding data structures (edge pool, flat rank arrays) are
    // this repo's own design.
    void traverse_heaviest_bundle() {
        int n = (int)nodes.size();
        std::vector<int> predecessors(n, -1);
        std::vector<long long> scores(n, -1);
        int max_score_id = 0;
        for (int nid : rank_to_node_id) {
            for (int ei : nodes[nid].in_edges) {
                const Edge& e = edges[ei];
                long long sp = (predecessors[nid] == -1)
                                   ? -1
                                   : scores[predecessors[nid]];
                if (scores[nid] < e.total_weight ||
                    (scores[nid] == e.total_weight &&
                     sp <= scores[e.begin])) {
                    scores[nid] = e.total_weight;
                    predecessors[nid] = e.begin;
                }
            }
            if (predecessors[nid] != -1)
                scores[nid] += scores[predecessors[nid]];
            if (scores[max_score_id] < scores[nid]) max_score_id = nid;
        }
        if (!nodes[max_score_id].out_edges.empty()) {
            std::vector<int> node_id_to_rank(n, 0);
            for (int r = 0; r < n; ++r)
                node_id_to_rank[rank_to_node_id[r]] = r;
            while (!nodes[max_score_id].out_edges.empty()) {
                max_score_id = branch_completion(
                    scores, predecessors, node_id_to_rank[max_score_id]);
            }
        }
        consensus_ids.clear();
        while (predecessors[max_score_id] != -1) {
            consensus_ids.push_back(max_score_id);
            max_score_id = predecessors[max_score_id];
        }
        consensus_ids.push_back(max_score_id);
        std::reverse(consensus_ids.begin(), consensus_ids.end());
    }

    int branch_completion(std::vector<long long>& scores,
                          std::vector<int>& predecessors, int rank) {
        int node_id = rank_to_node_id[rank];
        for (int ei : nodes[node_id].out_edges) {
            for (int oei : nodes[edges[ei].end].in_edges) {
                if (edges[oei].begin != node_id)
                    scores[edges[oei].begin] = -1;
            }
        }
        long long max_score = 0;
        int max_score_id = 0;
        for (size_t r = rank + 1; r < rank_to_node_id.size(); ++r) {
            int nid = rank_to_node_id[r];
            scores[nid] = -1;
            predecessors[nid] = -1;
            for (int ei : nodes[nid].in_edges) {
                const Edge& e = edges[ei];
                if (scores[e.begin] == -1) continue;
                long long sp = (predecessors[nid] == -1)
                                   ? -1
                                   : scores[predecessors[nid]];
                if (scores[nid] < e.total_weight ||
                    (scores[nid] == e.total_weight &&
                     sp <= scores[e.begin])) {
                    scores[nid] = e.total_weight;
                    predecessors[nid] = e.begin;
                }
            }
            if (predecessors[nid] != -1)
                scores[nid] += scores[predecessors[nid]];
            if (max_score < scores[nid]) {
                max_score = scores[nid];
                max_score_id = nid;
            }
        }
        return max_score_id;
    }

    std::string consensus() {
        traverse_heaviest_bundle();
        std::string out;
        out.reserve(consensus_ids.size());
        for (int nid : consensus_ids) out.push_back(decoder[nodes[nid].code]);
        return out;
    }

    void msa_ids(std::vector<int>& ids) const {
        ids.assign(nodes.size(), 0);
        int msa_id = 0;
        for (size_t r = 0; r < rank_to_node_id.size();) {
            int nid = rank_to_node_id[r];
            ids[nid] = msa_id;
            size_t na = nodes[nid].aligned.size();
            for (size_t a = 1; a <= na; ++a) ids[rank_to_node_id[r + a]] = msa_id;
            r += na + 1;
            ++msa_id;
        }
    }

    int successor(int nid, int label) const {
        for (int ei : nodes[nid].out_edges) {
            for (int l : edges[ei].labels)
                if (l == label) return edges[ei].end;
        }
        return -1;
    }

    std::string consensus_custom(std::vector<int32_t>& dst) {
        std::string cons = consensus();
        dst.assign(consensus_ids.size(), 0);
        std::vector<int> ids;
        msa_ids(ids);
        std::vector<int> cons_msa(consensus_ids.size());
        for (size_t c = 0; c < consensus_ids.size(); ++c)
            cons_msa[c] = ids[consensus_ids[c]];
        for (int s = 0; s < num_sequences; ++s) {
            int node_id = seq_begin[s];
            if (node_id < 0) continue;
            size_t c = 0;
            while (true) {
                while (c < consensus_ids.size() &&
                       cons_msa[c] < ids[node_id])
                    ++c;
                if (c >= consensus_ids.size()) break;
                if (cons_msa[c] == ids[node_id]) {
                    if (decoder[nodes[node_id].code] == cons[c]) ++dst[c];
                }
                int nxt = successor(node_id, s);
                if (nxt < 0) break;
                node_id = nxt;
            }
        }
        return cons;
    }
};

// ------------------- window consensus (engine.py logic) ----------------
// arms: concatenated strings; arm_lens/arm_kinds arrays.
// kinds: 0 internal, 1 prefix, 2 suffix.
std::string window_consensus_impl(
    int wtype, const char* draft, int draft_len, const char* arms,
    const int32_t* arm_lens, const int32_t* arm_kinds, int n_arms,
    int num_internal, int num_empty, int m, int n, int g, int fix_modes) {
    // gather arm offsets
    std::vector<const char*> aptr(n_arms);
    std::vector<int> alen(n_arms);
    {
        const char* p = arms;
        for (int i = 0; i < n_arms; ++i) {
            aptr[i] = p;
            alen[i] = arm_lens[i];
            p += arm_lens[i];
        }
    }
    std::string draft_s(draft, draft_len);
    auto align_add = [&](Graph& graph, const std::string& s, int mode) {
        std::vector<int32_t> an, as;
        graph.align(s.c_str(), (int)s.size(), mode, m, n, g, an, as);
        graph.add_alignment(an.data(), as.data(), (int)an.size(),
                            s.c_str(), (int)s.size());
    };

    if (wtype == 0) {  // SHORT path
        Graph graph;
        bool arms_added = false;
        bool any_internal = false;
        for (int i = 0; i < n_arms; ++i)
            if (arm_kinds[i] == 0) any_internal = true;
        if (!any_internal) {
            std::string s = "J" + draft_s + "O";
            align_add(graph, s, MODE_NW);
        }
        for (int i = 0; i < n_arms; ++i) {
            if (arm_kinds[i] == 0 && alen[i] > 0) {
                std::string s =
                    "J" + std::string(aptr[i], alen[i]) + "O";
                arms_added = true;
                align_add(graph, s, MODE_NW);
            }
        }
        for (int i = n_arms - 1; i >= 0; --i) {  // prefixes reversed
            if (arm_kinds[i] == 1 && alen[i] > 0) {
                std::string s = "J" + std::string(aptr[i], alen[i]);
                arms_added = true;
                align_add(graph, s, MODE_LOV);
            }
        }
        for (int i = 0; i < n_arms; ++i) {
            if (arm_kinds[i] == 2 && alen[i] > 0) {
                std::string s = std::string(aptr[i], alen[i]) + "O";
                arms_added = true;
                align_add(graph, s, MODE_ROV);
            }
        }
        if (!arms_added) return draft_s;
        std::string cons = graph.consensus();
        if (cons.size() <= 2) return std::string();
        return cons.substr(1, cons.size() - 2);
    }

    // LONG path: two rounds
    int mode_pre = fix_modes ? MODE_LOV : MODE_NW;
    int mode_suf = fix_modes ? MODE_ROV : MODE_NW;
    std::string backbone = draft_s;
    std::string curated;
    for (int round = 0; round < 2; ++round) {
        Graph graph;
        bool arms_added = false;
        if (!backbone.empty()) align_add(graph, backbone, MODE_NW);
        for (int i = 0; i < n_arms; ++i) {
            if (arm_kinds[i] == 0 && alen[i] > 0) {
                arms_added = true;
                align_add(graph, std::string(aptr[i], alen[i]), MODE_NW);
            }
        }
        for (int i = 0; i < n_arms; ++i) {
            if (arm_kinds[i] == 1 && alen[i] > 0) {
                arms_added = true;
                align_add(graph, std::string(aptr[i], alen[i]), mode_pre);
            }
        }
        for (int i = 0; i < n_arms; ++i) {
            if (arm_kinds[i] == 2 && alen[i] > 0) {
                arms_added = true;
                align_add(graph, std::string(aptr[i], alen[i]), mode_suf);
            }
        }
        if (!arms_added) return draft_s;
        std::vector<int32_t> dst;
        std::string cons = graph.consensus_custom(dst);
        long long th = (long long)(num_internal * 0.4);
        curated.clear();
        for (size_t c = 0; c < cons.size(); ++c)
            if (dst[c] >= th) curated.push_back(cons[c]);
        backbone = curated;
    }
    return curated;
}

}  // namespace

// ----------------------------- C API -----------------------------------
extern "C" {

void* hypo_graph_new() { return new Graph(); }
void hypo_graph_free(void* h) { delete (Graph*)h; }

void hypo_graph_add_alignment(void* h, const int32_t* anode,
                              const int32_t* aseq, int alen,
                              const char* seq, int slen) {
    ((Graph*)h)->add_alignment(anode, aseq, alen, seq, slen);
}

int hypo_graph_align(void* h, const char* seq, int slen, int mode, int m,
                     int n, int g, int32_t* out_nodes, int32_t* out_seq,
                     int cap) {
    std::vector<int32_t> an, as;
    ((Graph*)h)->align(seq, slen, mode, m, n, g, an, as);
    if ((int)an.size() > cap) return -1;
    std::memcpy(out_nodes, an.data(), an.size() * 4);
    std::memcpy(out_seq, as.data(), as.size() * 4);
    return (int)an.size();
}

int hypo_graph_num_nodes(void* h) {
    return (int)((Graph*)h)->nodes.size();
}

int hypo_graph_consensus(void* h, char* out, int cap) {
    std::string c = ((Graph*)h)->consensus();
    if ((int)c.size() > cap) return -1;
    std::memcpy(out, c.data(), c.size());
    return (int)c.size();
}

int hypo_graph_consensus_custom(void* h, char* out, int32_t* dst,
                                int cap) {
    std::vector<int32_t> d;
    std::string c = ((Graph*)h)->consensus_custom(d);
    if ((int)c.size() > cap) return -1;
    std::memcpy(out, c.data(), c.size());
    std::memcpy(dst, d.data(), d.size() * 4);
    return (int)c.size();
}

// Extraction for the device DP (global alphabet ACGTJO = 0..5).
int hypo_graph_extract(void* h, int N, int P, int32_t* node_code,
                       int32_t* pred_rows, int32_t* pred_cnt,
                       uint8_t* is_end, int32_t* rank_ids) {
    Graph* gr = (Graph*)h;
    int nn = (int)gr->rank_to_node_id.size();
    if (nn > N) return -1;
    static const char* ALPHA = "ACGTJO";
    std::vector<int> rank_of(gr->nodes.size(), 0);
    for (int r = 0; r < nn; ++r) rank_of[gr->rank_to_node_id[r]] = r;
    for (int r = 0; r < nn; ++r) {
        int nid = gr->rank_to_node_id[r];
        const Node& node = gr->nodes[nid];
        char c = gr->decoder[node.code];
        const char* pos = std::strchr(ALPHA, c);
        node_code[r] = pos ? (int)(pos - ALPHA) : 0;
        rank_ids[r] = nid;
        if (node.in_edges.empty()) {
            pred_cnt[r] = 1;
            pred_rows[(size_t)r * P] = 0;
        } else {
            if ((int)node.in_edges.size() > P) return -2;
            pred_cnt[r] = (int)node.in_edges.size();
            for (size_t p = 0; p < node.in_edges.size(); ++p)
                pred_rows[(size_t)r * P + p] =
                    rank_of[gr->edges[node.in_edges[p]].begin] + 1;
        }
        is_end[r] = node.out_edges.empty() ? 1 : 0;
    }
    return nn;
}

int hypo_window_consensus(int wtype, const char* draft, int draft_len,
                          const char* arms, const int32_t* arm_lens,
                          const int32_t* arm_kinds, int n_arms,
                          int num_internal, int num_empty, int m, int n,
                          int g, int fix_modes, char* out, int cap) {
    std::string c = window_consensus_impl(
        wtype, draft, draft_len, arms, arm_lens, arm_kinds, n_arms,
        num_internal, num_empty, m, n, g, fix_modes);
    if ((int)c.size() > cap) return -1;
    std::memcpy(out, c.data(), c.size());
    return (int)c.size();
}

// Batched window consensus, OpenMP over windows (the reference's
// per-window OMP POA loop, src/Hypo.cpp:237-247).  Flattened layout:
//   drafts buf + d_off[nw+1]; arms buf with per-arm arm_lens/arm_kinds
//   (concatenated per window) and per-window arm index range
//   win_arm_off[nw+1]; wtypes / num_internal / num_empty per window.
// Scores: (ms,ns,gs) for SHORT windows, (ml,nl,gl) for LONG windows.
// Output: each window w may write up to out_cap[w] bytes at out_off[w];
// out_len[w] receives the actual length (-1 = overflow).
void hypo_window_consensus_batch(
    const char* drafts, const int64_t* d_off,
    const char* arms, const int64_t* a_off,
    const int32_t* arm_lens, const int32_t* arm_kinds,
    const int64_t* win_arm_off,
    const int32_t* wtypes, const int32_t* num_internal,
    const int32_t* num_empty, int64_t nw,
    int ms, int ns, int gs, int ml, int nl, int gl, int fix_modes,
    char* out, const int64_t* out_off, const int64_t* out_cap,
    int64_t* out_len, int nthreads) {
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
#pragma omp parallel for schedule(dynamic, 8)
    for (int64_t w = 0; w < nw; ++w) {
        const int64_t af = win_arm_off[w], al = win_arm_off[w + 1];
        const int wt = wtypes[w];
        std::string c = window_consensus_impl(
            wt, drafts + d_off[w], (int)(d_off[w + 1] - d_off[w]),
            arms + a_off[af], arm_lens + af, arm_kinds + af,
            (int)(al - af), num_internal[w], num_empty[w],
            wt == 0 ? ms : ml, wt == 0 ? ns : nl, wt == 0 ? gs : gl,
            fix_modes);
        if ((int64_t)c.size() > out_cap[w]) {
            out_len[w] = -1;
        } else {
            std::memcpy(out + out_off[w], c.data(), c.size());
            out_len[w] = (int64_t)c.size();
        }
    }
}

// Flat jobs consensus: the host-engine twin of the device tile path.
// Consumes the deduplicated, weighted, marker-flanked ext entries the
// native tile-job builder emits (host_native.cpp hypo_tile_jobs; codes
// ACGTJO = 0..5) and runs each job's POA fully in C with OpenMP —
// no per-window Python objects, no per-window arm materialization.
// Merging one arm with weight w is exactly merging w identical copies:
// the second copy's optimal alignment is its own existing path, so the
// edge-weight increments are identical (the device engine relies on the
// same property; outputs were md5-identical across engines at 100 Mbp).
// Reference analog: the per-window OMP POA loop, src/Hypo.cpp:237-247,
// over spoa's SIMD engine.
namespace {
struct JobsCons {
    std::vector<int64_t> off;   // [n_jobs + 1]
    std::vector<char> buf;      // ASCII consensus, markers stripped
};
}  // namespace

void* hypo_jobs_consensus(
    int64_t n_jobs, const int64_t* job_ext_off, const int32_t* ext_len,
    const int8_t* ext_mode, const int32_t* ext_w, const int64_t* ext_off,
    const int8_t* ext_buf, int m, int n, int g, int nthreads) {
    static const char* ALPHA = "ACGTJO";
    auto* R = new JobsCons();
    std::vector<std::string> out((size_t)n_jobs);
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
#pragma omp parallel
    {
        std::string s;
        std::vector<int32_t> an, as;
#pragma omp for schedule(dynamic, 16)
        for (int64_t j = 0; j < n_jobs; ++j) {
            Graph graph;
            for (int64_t e = job_ext_off[j]; e < job_ext_off[j + 1];
                 ++e) {
                const int8_t* p = ext_buf + ext_off[e];
                const int32_t len = ext_len[e];
                s.resize((size_t)len);
                for (int32_t i = 0; i < len; ++i)
                    s[i] = ALPHA[p[i] < 6 ? p[i] : 0];
                graph.align(s.c_str(), len, (int)ext_mode[e], m, n, g,
                            an, as);
                graph.add_alignment(an.data(), as.data(), (int)an.size(),
                                    s.c_str(), len, (int)ext_w[e]);
            }
            std::string c = graph.consensus();
            out[(size_t)j] = c.size() <= 2
                                 ? std::string()
                                 : c.substr(1, c.size() - 2);
        }
    }
    R->off.resize((size_t)n_jobs + 1);
    R->off[0] = 0;
    size_t total = 0;
    for (int64_t j = 0; j < n_jobs; ++j) {
        total += out[(size_t)j].size();
        R->off[(size_t)j + 1] = (int64_t)total;
    }
    R->buf.resize(total);
    for (int64_t j = 0; j < n_jobs; ++j)
        std::memcpy(R->buf.data() + R->off[(size_t)j],
                    out[(size_t)j].data(), out[(size_t)j].size());
    return R;
}

int64_t hypo_jobs_cons_size(void* h) {
    return (int64_t)((JobsCons*)h)->buf.size();
}
const int64_t* hypo_jobs_cons_off(void* h) {
    return ((JobsCons*)h)->off.data();
}
const char* hypo_jobs_cons_buf(void* h) {
    return ((JobsCons*)h)->buf.data();
}
void hypo_jobs_cons_free(void* h) { delete (JobsCons*)h; }

}  // extern "C"
